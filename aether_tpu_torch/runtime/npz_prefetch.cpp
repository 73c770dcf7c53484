// Native training-data loader: threaded .npz prefetch with in-order delivery.
//
// The PyTorch trainer (aether_tpu_torch/train) consumes one compressed-latent
// .npz per clip (written by train/data.py::precompute_latents). Loading one
// synchronously costs file IO + zlib inflate on the host — dead time between
// device steps. This loader runs both on a small thread pool and hands
// finished batches back in submit order, so the next batch is always hot.
//
// It is host code, not a device kernel: the training step runs on the GPU,
// and this file takes IO + decode off the Python thread.
//
// Format notes:
//   .npz = zip of .npy members; numpy writes deflate (method 8) or stored
//   (method 0) entries with sizes recorded in the central directory, which we
//   parse from the EOCD record. .npy v1/v2 headers carry a Python-dict
//   literal: {'descr': '<f2', 'fortran_order': False, 'shape': (11, 56, ...)}.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC npz_prefetch.cpp \
//            -o ../_build/libnpz_prefetch_<hash>.so -lz -pthread
// (done at first use by aether_tpu_torch/runtime/__init__.py; a failed build
// raises there with the compiler's message).

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxArrays = 32;
constexpr int kMaxDims = 8;

struct NpzArray {
  char name[64];
  char dtype[16];   // numpy descr, e.g. "<f2"
  int64_t ndim;
  int64_t shape[kMaxDims];
  void* data;
  int64_t nbytes;
};

struct NpzBatch {
  int64_t n_arrays;
  NpzArray arrays[kMaxArrays];
  int64_t status;   // 0 ok, nonzero = error
  char error[256];
  char path[1024];
};

void set_error(NpzBatch* b, const std::string& msg) {
  b->status = 1;
  std::snprintf(b->error, sizeof(b->error), "%s", msg.c_str());
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

bool inflate_raw(const uint8_t* src, size_t src_len, uint8_t* dst,
                 size_t dst_len) {
  z_stream strm;
  std::memset(&strm, 0, sizeof(strm));
  if (inflateInit2(&strm, -MAX_WBITS) != Z_OK) return false;
  strm.next_in = const_cast<uint8_t*>(src);
  strm.avail_in = static_cast<uInt>(src_len);
  strm.next_out = dst;
  strm.avail_out = static_cast<uInt>(dst_len);
  int rc = inflate(&strm, Z_FINISH);
  inflateEnd(&strm);
  return rc == Z_STREAM_END && strm.total_out == dst_len;
}

// Parse a .npy buffer into desc fields + a malloc'd copy of the payload.
bool parse_npy(const uint8_t* buf, size_t len, NpzArray* out,
               std::string* err) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) {
    *err = "bad npy magic";
    return false;
  }
  int major = buf[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(buf + 8);
    hoff = 10;
  } else {
    if (len < 12) { *err = "short npy v2 header"; return false; }
    hlen = rd32(buf + 8);
    hoff = 12;
  }
  if (hoff + hlen > len) { *err = "npy header exceeds buffer"; return false; }
  std::string hdr(reinterpret_cast<const char*>(buf + hoff), hlen);

  auto find_value = [&](const char* key) -> std::string {
    size_t k = hdr.find(key);
    if (k == std::string::npos) return "";
    size_t colon = hdr.find(':', k);
    if (colon == std::string::npos) return "";
    size_t end = colon + 1;
    int depth = 0;
    while (end < hdr.size()) {
      char c = hdr[end];
      if (c == '(' || c == '[') depth++;
      if (c == ')' || c == ']') {
        if (depth == 0) break;
        depth--;
      }
      if ((c == ',' || c == '}') && depth == 0) break;
      end++;
    }
    return hdr.substr(colon + 1, end - colon - 1);
  };

  std::string descr = find_value("'descr'");
  // strip whitespace and quotes
  std::string d;
  for (char c : descr)
    if (c != ' ' && c != '\'' && c != '"') d += c;
  if (d.empty() || d.size() >= sizeof(out->dtype)) {
    *err = "unsupported descr";
    return false;
  }
  // only simple little-endian/byte-order-free numeric scalars: '<f2', '|u1',
  // '=i4', ... Strings ('<U10': itemsize 4*10, not 10), bytes, objects,
  // datetimes and structured dtypes would be silently mis-sized by the
  // digits-from-descr element-size parse below — reject them explicitly.
  {
    size_t t = 0;
    if (d[t] == '<' || d[t] == '|' || d[t] == '=') t++;
    else if (d[t] == '>') { *err = "big-endian descr unsupported: " + d; return false; }
    if (t >= d.size() ||
        (d[t] != 'b' && d[t] != 'i' && d[t] != 'u' && d[t] != 'f' &&
         d[t] != 'c')) {
      *err = "non-numeric descr unsupported: " + d;
      return false;
    }
    for (size_t i = t + 1; i < d.size(); ++i) {
      if (d[i] < '0' || d[i] > '9') {
        *err = "non-numeric descr unsupported: " + d;
        return false;
      }
    }
  }
  std::snprintf(out->dtype, sizeof(out->dtype), "%s", d.c_str());

  std::string fortran = find_value("'fortran_order'");
  if (fortran.find("True") != std::string::npos) {
    *err = "fortran_order arrays unsupported";
    return false;
  }

  std::string shape = find_value("'shape'");
  out->ndim = 0;
  int64_t elems = 1;
  const char* p = shape.c_str();
  while (*p) {
    if (*p >= '0' && *p <= '9') {
      int64_t v = 0;
      while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
      if (out->ndim >= kMaxDims) { *err = "too many dims"; return false; }
      out->shape[out->ndim++] = v;
      elems *= v;
    } else {
      p++;
    }
  }

  // element size from descr tail (e.g. <f2 -> 2); '|b1'/'|u1' style too
  int esize = 0;
  for (char c : d)
    if (c >= '0' && c <= '9') esize = esize * 10 + (c - '0');
  if (esize <= 0 || esize > 16) { *err = "bad element size"; return false; }

  int64_t nbytes = elems * esize;
  if (hoff + hlen + nbytes > len) { *err = "npy payload truncated"; return false; }
  out->nbytes = nbytes;
  out->data = std::malloc(nbytes ? nbytes : 1);
  if (!out->data) { *err = "oom"; return false; }
  std::memcpy(out->data, buf + hoff + hlen, nbytes);
  return true;
}

void load_npz(const char* path, NpzBatch* b) {
  std::snprintf(b->path, sizeof(b->path), "%s", path);
  b->n_arrays = 0;
  b->status = 0;
  b->error[0] = 0;

  FILE* f = std::fopen(path, "rb");
  if (!f) { set_error(b, "cannot open file"); return; }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (std::fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f);
    set_error(b, "short read");
    return;
  }
  std::fclose(f);

  // find EOCD (PK\x05\x06) scanning back from the end
  long eocd = -1;
  for (long i = fsize - 22; i >= 0 && i >= fsize - 22 - 65536; --i) {
    if (buf[i] == 0x50 && buf[i + 1] == 0x4b && buf[i + 2] == 0x05 &&
        buf[i + 3] == 0x06) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) { set_error(b, "no zip EOCD record"); return; }
  uint16_t n_entries = rd16(&buf[eocd + 10]);
  uint32_t cd_off = rd32(&buf[eocd + 16]);
  // Zip64 archives (> 4 GB members/offsets or > 65534 entries) store 0xFFFF /
  // 0xFFFFFFFF sentinels here with the real values in a Zip64 EOCD record,
  // which this parser does not read — fail loudly instead of mis-seeking.
  if (n_entries == 0xFFFF || cd_off == 0xFFFFFFFFu) {
    set_error(b, "zip64 archive unsupported (use the np.load fallback)");
    return;
  }

  size_t pos = cd_off;
  for (int e = 0; e < n_entries; ++e) {
    if (pos + 46 > static_cast<size_t>(fsize) ||
        rd32(&buf[pos]) != 0x02014b50) {
      set_error(b, "bad central directory entry");
      return;
    }
    uint16_t method = rd16(&buf[pos + 10]);
    uint32_t csize = rd32(&buf[pos + 20]);
    uint32_t usize = rd32(&buf[pos + 24]);
    uint16_t nlen = rd16(&buf[pos + 28]);
    uint16_t xlen = rd16(&buf[pos + 30]);
    uint16_t clen = rd16(&buf[pos + 32]);
    uint32_t lho = rd32(&buf[pos + 42]);
    std::string name(reinterpret_cast<char*>(&buf[pos + 46]), nlen);
    pos += 46 + nlen + xlen + clen;
    if (csize == 0xFFFFFFFFu || usize == 0xFFFFFFFFu || lho == 0xFFFFFFFFu) {
      set_error(b, "zip64 member unsupported: " + name);
      return;
    }

    if (b->n_arrays >= kMaxArrays) { set_error(b, "too many arrays"); return; }
    // local header: recompute the data offset (local xlen can differ)
    if (lho + 30 > static_cast<size_t>(fsize) ||
        rd32(&buf[lho]) != 0x04034b50) {
      set_error(b, "bad local header");
      return;
    }
    uint16_t lnlen = rd16(&buf[lho + 26]);
    uint16_t lxlen = rd16(&buf[lho + 28]);
    size_t data_off = lho + 30 + lnlen + lxlen;
    if (data_off + csize > static_cast<size_t>(fsize)) {
      set_error(b, "zip member truncated");
      return;
    }

    std::vector<uint8_t> raw;
    const uint8_t* npy = nullptr;
    size_t npy_len = 0;
    if (method == 0) {
      npy = &buf[data_off];
      npy_len = usize;
    } else if (method == 8) {
      raw.resize(usize);
      if (!inflate_raw(&buf[data_off], csize, raw.data(), usize)) {
        set_error(b, "inflate failed for " + name);
        return;
      }
      npy = raw.data();
      npy_len = usize;
    } else {
      set_error(b, "unsupported zip method");
      return;
    }

    NpzArray* arr = &b->arrays[b->n_arrays];
    std::string key = name;
    if (key.size() > 4 && key.substr(key.size() - 4) == ".npy")
      key = key.substr(0, key.size() - 4);
    if (key.size() >= sizeof(arr->name)) {
      // snprintf truncation could silently collide two long keys
      set_error(b, "member name too long (>= 64 chars): " + key);
      return;
    }
    std::snprintf(arr->name, sizeof(arr->name), "%s", key.c_str());
    std::string err;
    if (!parse_npy(npy, npy_len, arr, &err)) {
      set_error(b, err + " in " + name);
      return;
    }
    b->n_arrays++;
  }
}

struct Prefetcher {
  std::mutex mu;
  std::condition_variable cv_workers, cv_consumer;
  std::deque<std::pair<int64_t, std::string>> pending;  // (ticket, path)
  std::deque<std::pair<int64_t, NpzBatch*>> done;
  int64_t next_submit = 0;
  int64_t next_deliver = 0;
  bool shutdown = false;
  std::vector<std::thread> workers;

  explicit Prefetcher(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { run(); });
  }

  ~Prefetcher() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_workers.notify_all();
    cv_consumer.notify_all();
    for (auto& t : workers) t.join();
    for (auto& d : done) {
      for (int i = 0; i < d.second->n_arrays; ++i)
        std::free(d.second->arrays[i].data);
      delete d.second;
    }
  }

  void run() {
    for (;;) {
      std::pair<int64_t, std::string> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_workers.wait(lk, [this] { return shutdown || !pending.empty(); });
        if (shutdown) return;
        job = pending.front();
        pending.pop_front();
      }
      NpzBatch* b = new NpzBatch();
      load_npz(job.second.c_str(), b);
      {
        std::lock_guard<std::mutex> lk(mu);
        done.emplace_back(job.first, b);
      }
      cv_consumer.notify_all();
    }
  }

  int64_t submit(const char* path) {
    std::lock_guard<std::mutex> lk(mu);
    int64_t ticket = next_submit++;
    pending.emplace_back(ticket, path);
    cv_workers.notify_one();
    return ticket;
  }

  NpzBatch* wait_next() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (next_deliver >= next_submit) return nullptr;  // nothing in flight
      for (auto it = done.begin(); it != done.end(); ++it) {
        if (it->first == next_deliver) {
          NpzBatch* b = it->second;
          done.erase(it);
          next_deliver++;
          return b;
        }
      }
      cv_consumer.wait(lk);
    }
  }
};

}  // namespace

extern "C" {

void* npzp_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Prefetcher(n_threads);
}

void npzp_destroy(void* ctx) { delete static_cast<Prefetcher*>(ctx); }

long npzp_submit(void* ctx, const char* path) {
  return static_cast<Prefetcher*>(ctx)->submit(path);
}

// Blocks until the next batch (in submit order) is ready. NULL if none pending.
NpzBatch* npzp_wait(void* ctx) {
  return static_cast<Prefetcher*>(ctx)->wait_next();
}

void npzp_release(NpzBatch* b) {
  if (!b) return;
  for (int i = 0; i < b->n_arrays; ++i) std::free(b->arrays[i].data);
  delete b;
}

// One-shot synchronous load (used by tests and as a simple native np.load).
NpzBatch* npzp_load(const char* path) {
  NpzBatch* b = new NpzBatch();
  load_npz(path, b);
  return b;
}

}  // extern "C"
