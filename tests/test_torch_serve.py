"""The port's web server (``aether_tpu_torch.apps.serve``) on the CPU.

Every flow of ``tests/test_serve.py`` over the port's server at the tiny
config (``--random-init tiny --device cpu``), through real multipart uploads
(PIL and ``imageio`` decode them): the index and raymap listing, a prediction
job with a generated raymap, the advanced options, a reconstruction with
staged progress and a GLB for the viewer, the queue rejecting when full, the
stats, the warmup and the oversized upload; then what is the port's own: the
routes' error answers, the command line's refusals, and the job table and
the kernels' launch counters under many threads. The parity of its jobs with
the JAX ``JobRunner`` is in ``tests/test_torch_serve_parity.py``.
"""

import io
import json
import queue
import struct
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from aether_tpu_torch.apps import serve
from aether_tpu_torch.apps.actions import NAMED_ACTIONS
from aether_tpu_torch.utils.profiling import stage_report

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    from http.server import ThreadingHTTPServer
    from types import SimpleNamespace

    from aether_tpu_torch.apps.demo import build_pipeline

    pipe, _ = build_pipeline(serve.parse_args(["--random-init", "tiny", "--device", "cpu"]))
    out_dir = str(tmp_path_factory.mktemp("serve_out"))
    runner = serve.JobRunner(pipe, out_dir)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(runner, None))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield SimpleNamespace(url=f"http://127.0.0.1:{httpd.server_address[1]}",
                          runner=runner, pipeline=pipe)
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def server(stack):
    return stack.url


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def multipart(fields, files, boundary="testboundary123"):
    body = io.BytesIO()
    for name, value in fields.items():
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                   f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
    for name, (filename, data) in files.items():
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                   f"name=\"{name}\"; filename=\"{filename}\"\r\n"
                   f"Content-Type: application/octet-stream\r\n\r\n".encode())
        body.write(data)
        body.write(b"\r\n")
    body.write(f"--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


def _submit_multipart(url, fields, files):
    data, content_type = multipart(fields, files)
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def gif_bytes(frames=17, h=64, w=96):
    from PIL import Image

    x = np.broadcast_to(np.linspace(0, 255, w)[None, :], (h, w))
    y = np.broadcast_to(np.linspace(0, 255, h)[:, None], (h, w))
    imgs = [Image.fromarray(np.stack([x, y, np.full((h, w), 40 + t * 10)], -1)
                            .astype(np.uint8)) for t in range(frames)]
    buf = io.BytesIO()
    imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:], duration=80,
                 loop=0)
    return buf.getvalue()


def png_bytes(seed, h=64, w=96):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).uniform(0, 255, (h, w, 3))
                    .astype("uint8")).save(buf, format="PNG")
    return buf.getvalue()


def _wait(server, job_id, seconds=300):
    seen = []
    for _ in range(seconds * 5):
        status = json.loads(_get(f"{server}/api/status/{job_id}"))
        seen.append(status.get("progress") or {})
        if status["status"] in ("done", "error"):
            return status, seen
        time.sleep(0.2)
    raise AssertionError(f"job {job_id} did not finish")


def test_index_and_raymaps(server):
    html = _get(server + "/").decode()
    assert "viewer" in html and "showGLB" in html  # embedded 3D viewer
    assert json.loads(_get(server + "/api/raymaps")) == sorted(NAMED_ACTIONS)


def test_prediction_job_with_generated_raymap(server):
    resp = _submit_multipart(
        server + "/api/submit",
        {"task": "prediction", "num_frames": "17", "fps": "12", "steps": "1",
         "height": "64", "width": "96", "raymap": "forward"},
        {"image": ("obs.png", png_bytes(2))})
    status, _ = _wait(server, resp["job_id"])
    assert status["status"] == "done", status.get("error")
    assert any(a.endswith(".glb") for a in status["artifacts"])
    stages = [s["stage"] for s in status["progress"]["stages_done"]]
    # the prediction, then the 4-step post-reconstruction
    assert stages == ["vae_encode", "denoise", "vae_decode"] * 2, stages


def test_prediction_advanced_options(server):
    """post_reconstruction=no runs one sampling pass and exports the
    prediction's own disparity and raymap."""
    resp = _submit_multipart(
        server + "/api/submit",
        {"task": "prediction", "num_frames": "17", "fps": "12", "steps": "1",
         "height": "64", "width": "96", "raymap": "forward", "seed": "7",
         "dynamic_cfg": "off", "post_reconstruction": "no", "smooth_camera": "no",
         "align_pointmaps": "yes", "pc_interval": "5", "max_depth": "50", "rtol": "0.1"},
        {"image": ("obs.png", png_bytes(5))})
    status, _ = _wait(server, resp["job_id"])
    assert status["status"] == "done", status.get("error")
    stages = [s["stage"] for s in status["progress"]["stages_done"]]
    assert sum(s == "denoise" for s in stages) == 1, stages
    glbs = [a for a in status["artifacts"] if a.endswith(".glb")]
    assert len(glbs) == 4  # frames 0, 5, 10, 15 of 17


def test_reconstruction_job_with_progress_and_glb(server):
    resp = _submit_multipart(
        server + "/api/submit",
        {"task": "reconstruction", "num_frames": "17", "fps": "12", "steps": "1",
         "stride": "8", "height": "64", "width": "96"},
        {"video": ("input.gif", gif_bytes(frames=25))})
    status, seen = _wait(server, resp["job_id"])
    assert status["status"] == "done", status.get("error")
    assert any(p.get("stage") or p.get("detail") for p in seen), "no staged progress"
    done = [d["stage"] for d in status["progress"]["stages_done"]]
    window = ["vae_encode", "denoise", "vae_decode"]
    # two windows (starts 0 and 8), each timed as dispatch@ and resolve@
    assert done == (window + ["dispatch@0"] + window
                    + ["dispatch@8", "resolve@0", "resolve@8"]), done

    glbs = [a for a in status["artifacts"] if a.endswith(".glb")]
    assert len(glbs) == 3  # frames 0, 10, 20 of 25
    # the viewer's data contract: GLB magic, JSON + BIN chunks, a POINTS
    # primitive with f32 POSITION (min/max present) and normalized u8 COLOR_0
    buf = _get(server + glbs[0])
    assert struct.unpack_from("<I", buf, 0)[0] == 0x46546C67
    off, js, binchunk = 12, None, None
    while off < len(buf):
        ln, typ = struct.unpack_from("<II", buf, off)
        data = buf[off + 8:off + 8 + ln]
        if typ == 0x4E4F534A:
            js = json.loads(data)
        elif typ == 0x004E4942:
            binchunk = data
        off += 8 + ln
    points = [pr for mesh in js["meshes"] for pr in mesh["primitives"] if pr.get("mode") == 0]
    assert points, "no POINTS primitive for the viewer"
    pa = js["accessors"][points[0]["attributes"]["POSITION"]]
    ca = js["accessors"][points[0]["attributes"]["COLOR_0"]]
    assert pa["componentType"] == 5126 and "min" in pa and "max" in pa
    assert ca["componentType"] == 5121 and ca.get("normalized") is True
    assert binchunk is not None and pa["count"] == ca["count"] > 0
    ply = [a for a in status["artifacts"] if a.endswith(".ply")]
    poses = [a for a in status["artifacts"] if a.endswith("_poses.txt")]
    assert len(ply) == 1 and _get(server + ply[0]).startswith(b"ply\n")
    assert np.loadtxt(io.BytesIO(_get(server + poses[0]))).shape == (25, 16)


class _NeverRun(serve.JobRunner):
    def _worker(self):  # jobs stay queued
        while True:
            time.sleep(3600)


class _CpuPipe:
    device = "cpu"


def test_queue_rejects_when_full():
    runner = _NeverRun(pipeline=_CpuPipe(), output_dir="/nonexistent", max_queue=2)
    runner.submit({"task": "reconstruction"})
    runner.submit({"task": "reconstruction"})
    with pytest.raises(queue.Full):
        runner.submit({"task": "reconstruction"})
    assert runner.counts() == {"queued": 2}  # the refused job left no entry


def test_queue_full_answers_429(stack, monkeypatch):
    full = _NeverRun(pipeline=_CpuPipe(), output_dir=stack.runner.output_dir, max_queue=1)
    full.submit({"task": "prediction"})
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(full, None))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _submit_multipart(f"http://127.0.0.1:{httpd.server_address[1]}/api/submit",
                              {"task": "prediction", "num_frames": "17"},
                              {"image": ("obs.png", png_bytes(1))})
        assert err.value.code == 429
        assert "queue full" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_close_stops_the_worker_and_releases_the_pipeline():
    import gc
    import weakref

    class Pipe:
        device = "cpu"

    pipe = Pipe()
    alive = weakref.ref(pipe)
    runner = serve.JobRunner(pipe, "/nonexistent")
    runner.close(timeout=10)
    assert not runner._thread.is_alive()
    del pipe, runner
    gc.collect()
    assert alive() is None


def test_close_is_bounded_by_its_timeout():
    runner = _NeverRun(pipeline=_CpuPipe(), output_dir="/nonexistent", max_queue=1)
    runner.submit({"task": "prediction"})  # the queue is full; the worker never drains it
    start = time.perf_counter()
    runner.close(timeout=0.2)
    assert time.perf_counter() - start < 5


class _CudaPipe:
    device = torch.device("cuda")  # no index, as torch.device(args.device) gives


def test_worker_makes_the_builders_device_current(monkeypatch):
    """An unindexed CUDA device becomes the building thread's current one,
    and the worker thread makes it its own current device."""
    made_current = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    runner = serve.JobRunner(_CudaPipe(), "/nonexistent")
    runner.close(timeout=10)
    assert runner.device == torch.device("cuda", 0)
    assert made_current == [torch.device("cuda", 0)]


def test_worker_reports_a_failed_device_setup(monkeypatch, capsys):
    """Where the worker cannot make the device current, every job ends in
    'error' with the reason, and the queue does not fill with stuck jobs."""
    def refuse(device):
        raise RuntimeError("invalid device ordinal")

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    runner = serve.JobRunner(_CudaPipe(), "/nonexistent", max_queue=1)
    ids = []
    for n in range(1, 4):  # one queue slot: each job must leave it in turn
        ids.append(runner.submit({"task": "prediction"}))
        deadline = time.time() + 10
        while runner.counts() != {"error": n} and time.time() < deadline:
            time.sleep(0.01)
    runner.close(timeout=10)
    assert not runner._thread.is_alive()
    for job_id in ids:
        status = runner.status(job_id)
        assert status["status"] == "error"
        assert "could not make cuda:0 current" in status["error"]
        assert "invalid device ordinal" in status["error"]
    assert "could not make cuda:0 current" in capsys.readouterr().err


def test_resolve_device_gives_cuda_an_index(monkeypatch):
    from aether_tpu_torch.apps.demo import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_stats_endpoint_reports_queue_and_stages(server):
    stats = json.loads(_get(server + "/api/stats"))
    assert isinstance(stats["queue_depth"], int)
    assert isinstance(stats["jobs"], dict)
    assert isinstance(stats["stages"], dict)
    if stats["jobs"].get("done"):
        assert stats["stages"]["denoise"]["count"] >= 1
        assert stats["stages"]["vae_decode"]["count"] >= 1


def test_warmup_runs_named_tasks(stack):
    serve.warmup(stack.pipeline, ["prediction", "reconstruction"], num_frames=17,
                 height=64, width=96, steps=1)
    report = stage_report()
    assert report["warmup/prediction"]["count"] >= 1
    assert report["warmup/reconstruction"]["count"] >= 1
    with pytest.raises(ValueError):
        serve.warmup(stack.pipeline, ["bogus"], num_frames=17, height=64, width=96)


def test_oversized_upload_rejected(server, monkeypatch):
    monkeypatch.setattr(serve, "MAX_UPLOAD_BYTES", 1000)
    with pytest.raises(urllib.error.HTTPError) as err:
        _submit_multipart(server + "/api/submit", {"task": "prediction", "num_frames": "17"},
                          {"image": ("big.png", b"x" * 5000)})
    assert err.value.code == 400
    assert "too large" in json.loads(err.value.read())["error"]


@pytest.mark.parametrize("path", ["/api/status/nosuchjob", "/outputs/../etc/passwd",
                                  "/outputs/%2e%2e/x", "/nowhere"])
def test_unknown_paths_answer_404(server, path):
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(server + path)
    assert err.value.code == 404


@pytest.mark.parametrize("fields,files,message", [
    ({"task": "bogus"}, {}, "invalid task"),
    ({"task": "reconstruction"}, {}, "requires a video"),
    ({"task": "planning"}, {"image": ("a.png", None)}, "requires a goal"),
    ({"task": "prediction", "raymap": "sideways"}, {"image": ("a.png", None)},
     "unknown raymap action"),
    ({"task": "prediction", "smooth_method": "spline"}, {"image": ("a.png", None)},
     "unknown smooth_method"),
])
def test_bad_requests_answer_400(server, fields, files, message):
    files = {k: (name, png_bytes(0)) for k, (name, _) in files.items()}
    with pytest.raises(urllib.error.HTTPError) as err:
        _submit_multipart(server + "/api/submit", fields, files)
    assert err.value.code == 400
    assert message in json.loads(err.value.read())["error"]


def test_fields_to_params_generates_whole_video_raymap():
    params = serve._fields_to_params(
        {"task": "reconstruction", "video": {"filename": "v.gif", "data": gif_bytes(25)},
         "raymap": "left", "height": "64", "width": "96", "dynamic_cfg": "on",
         "smooth_camera": "no"}, None)
    assert params["video_array"].shape == (25, 64, 96, 3)
    assert params["video_array"].dtype == np.float32 and params["video_array"].max() <= 1.0
    assert params["raymap_array"].shape == (25, 6, 8, 12)  # spans the whole video
    assert params["dynamic_cfg"] is True and params["smooth_camera"] is False
    assert params["post_reconstruction"] is True and params["align_pointmaps"] is False


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"], ["--wire_rgb", "u8"],
                                  ["--wire_disparity", "fp16"], ["--wire_input", "yuv420"]])
def test_main_refuses_unported_flags(flag, monkeypatch):
    """Every flag of the JAX server runs (the name is the one the test had
    while these flags raised): the wire flags reach the pipeline, and
    ``--dp/--tp`` in a lone process (world size 1) serve from one process,
    with no mesh and no job channel, as the JAX server builds no mesh on one
    device. The mesh itself is ``tests/test_torch_serve_mesh.py``'s."""
    served = {}
    monkeypatch.setattr(serve, "serve", lambda pipeline, output_dir, **kw: served.update(
        kw, pipeline=pipeline))
    serve.main(["--random-init", "tiny", "--device", "cpu", "--output_dir", "/nonexistent"]
               + flag)
    pipe = served["pipeline"]
    assert served["channel"] is None and pipe.mesh is None
    name, value = flag[0][2:], flag[1]
    if name.startswith("wire_"):
        assert getattr(pipe, name) == value
    assert (pipe.wire_rgb, pipe.wire_input, pipe.wire_disparity) == (
        "u8" if name == "wire_rgb" else None,
        "yuv420" if name == "wire_input" else "u8", "fp16")
    # the JAX defaults; compact stays automatic: off on the CPU, on for a card
    assert pipe.compact_transfer is None and pipe._modes(64, 96) == ("f32", "f32")


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    assert serve.parse_args(["--random-init", "tiny"]).device == "cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        serve.main(["--random-init", "tiny"])


def test_job_table_under_many_threads():
    """Submits and status reads from 16 threads at a short switch interval:
    every job is kept and counted once."""
    runner = _NeverRun(pipeline=_CpuPipe(), output_dir="/nonexistent", max_queue=1000)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    ids, errors = [], []

    def client():
        try:
            for _ in range(40):
                job = runner.submit({"task": "prediction"})
                ids.append(job)
                assert runner.status(job)["status"] == "queued"
                runner.counts()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert len(set(ids)) == 640 and runner.counts() == {"queued": 640}


def test_launch_counter_under_many_threads():
    """The kernels' launch counters are process-wide and lose no increment
    when several threads launch."""
    from aether_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000

