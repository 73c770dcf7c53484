"""Web serving app: browser UI + JSON API over the port's Aether pipeline.

Port of ``aether_tpu/apps/serve.py`` (the reference's ``scripts/demo_gradio.py``
as a dependency-free stdlib ``http.server``): the same three tasks behind a
queued web front-end with the reference's controls and advanced options,
canned or generated raymap actions for prediction, live staged progress, an
embedded WebGL point-cloud viewer and downloadable GLB / PLY / video
artifacts, over :class:`aether_tpu_torch.pipeline.AetherPipeline`:

- ``GET /``              single-page UI
- ``POST /api/submit``   multipart form (task, files, params) -> {"job_id"}
- ``GET /api/status/ID`` -> {"status", "artifacts": [...], "progress"} (poll)
- ``GET /outputs/...``   artifact downloads
- ``GET /api/raymaps``   canned and generated raymap action names
- ``GET /api/stats``     queue depth, jobs by status, accumulated stage times

Jobs run on one worker thread (the card is a serial resource), which makes
the pipeline's device its current CUDA device and holds the pipeline until
``JobRunner.close``; the queue is bounded at 20 like the reference's
``demo.queue(max_size=20)``. The job table is shared
with the HTTP threads under a lock. Uploads are decoded with PIL and
``imageio``, imported inside the decode functions.

It runs on the GPU: ``--device`` defaults to ``cuda`` and raises where there
is none. The weights come from ``--checkpoint`` or ``--random-init``, and the
``--wire_*`` flags pick the pipeline's wires, as in ``apps/demo.py``, whose
``build_pipeline`` builds the pipeline.

``--dp/--tp`` serve over a mesh, one process per card under ``torchrun``
(``apps.demo.build_mesh``). Where JAX has one controller driving every
chip, the port has a leader and followers: rank 0 binds HTTP, validates each
job (the pipeline's ``check_inputs``) and broadcasts it over a gloo job
channel of its own (``parallel/jobs.py``); every rank then makes the job's
device calls (:func:`job_calls`: the window driver with ``batch_windows``
the mesh's dp, or the sampling call and the post-reconstruction) in the
same order, and rank 0 alone blends and exports. Followers drop their
outputs and register no stage listeners; warmup runs on every rank. When
rank 0 stops (``JobRunner.close``, Ctrl-C, SIGTERM) it sends the stop
message and every rank leaves the process group. A rank whose device calls
fail leaves at once: the job ends in ``error`` on rank 0 and every rank
exits non-zero, the others when a collective finds it gone (at the latest
at the mesh's timeout).

Usage:
    python -m aether_tpu_torch.apps.serve --random-init aetherv1 \\
        --warmup reconstruction
    torchrun --nproc_per_node 2 -m aether_tpu_torch.apps.serve \\
        --random-init aetherv1 --dp 2
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import os
import queue
import signal
import sys
import threading
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

_INDEX_HTML = """<!doctype html>
<html><head><title>Aether-TPU</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto;padding:0 1em}
fieldset{margin:1em 0;border:1px solid #ccc;border-radius:6px}
label{display:block;margin:.5em 0}.row{display:flex;gap:1em;flex-wrap:wrap}
#log{white-space:pre-wrap;background:#f6f6f6;padding:1em;border-radius:6px}
#progress{background:#eef4ff;padding:.6em 1em;border-radius:6px;margin:.5em 0}
#bar{height:8px;background:#d0ddff;border-radius:4px;overflow:hidden}
#bar>div{height:100%;width:0;background:#3b6fe0;transition:width .3s}
#viewer{width:100%;height:480px;background:#111;border-radius:6px;display:none}
a{display:block}</style></head><body>
<h1>Aether-TPU world model</h1>
<form id="f">
<fieldset><legend>Task</legend>
<label><input type="radio" name="task" value="reconstruction" checked> 4D reconstruction (video)</label>
<label><input type="radio" name="task" value="prediction"> Action-conditioned prediction (image + raymap)</label>
<label><input type="radio" name="task" value="planning"> Goal-conditioned planning (image + goal)</label>
</fieldset>
<fieldset><legend>Inputs</legend>
<label>Video (reconstruction): <input type="file" name="video"></label>
<label>Image (prediction/planning): <input type="file" name="image"></label>
<label>Goal image (planning): <input type="file" name="goal"></label>
<label>Raymap action: <select name="raymap"><option value="">none</option></select></label>
</fieldset>
<fieldset><legend>Parameters</legend><div class="row">
<label>frames <select name="num_frames"><option>17</option><option>25</option>
<option>33</option><option selected>41</option></select></label>
<label>fps <select name="fps"><option>8</option><option>10</option>
<option selected>12</option><option>15</option><option>24</option></select></label>
<label>steps <input name="steps" type="number" value="" placeholder="task default" style="width:5em"></label>
<label>stride <input name="stride" type="number" value="24" style="width:4em"></label>
<label>cfg <input name="cfg" type="number" step="0.5" value="" placeholder="task default" style="width:4em"></label>
<label>height <input name="height" type="number" value="480" style="width:4.5em"></label>
<label>width <input name="width" type="number" value="720" style="width:4.5em"></label>
</div></fieldset>
<details><summary>Advanced</summary><fieldset><div class="row">
<label>seed <input name="seed" type="number" value="42" style="width:6em"></label>
<label>dynamic CFG <select name="dynamic_cfg"><option value="">task default</option>
<option>on</option><option>off</option></select></label>
<label>post-reconstruction <select name="post_reconstruction">
<option selected>yes</option><option>no</option></select></label>
<label>smooth camera <select name="smooth_camera">
<option selected>yes</option><option>no</option></select></label>
<label>smooth method <select name="smooth_method"><option selected>kalman</option>
<option>gaussian</option><option>savgol</option><option>ma</option></select></label>
<label>align pointmaps <select name="align_pointmaps">
<option selected>no</option><option>yes</option></select></label>
<label>max depth <input name="max_depth" type="number" value="100" style="width:5em"></label>
<label>rtol <input name="rtol" type="number" step="0.01" value="0.2" style="width:5em"></label>
<label>GLB every Nth frame <input name="pc_interval" type="number" value="10" style="width:4em"></label>
</div></fieldset></details>
<button type="submit">Run</button></form>
<h2>Progress</h2>
<div id="progress">idle<div id="bar"><div></div></div></div>
<h2>3D point cloud</h2>
<label>Frame: <select id="frame_sel"></select></label>
<canvas id="viewer"></canvas>
<h2>Artifacts</h2><div id="artifacts"></div>
<details><summary>raw status</summary><div id="log"></div></details>
<script>
fetch('/api/raymaps').then(r=>r.json()).then(names=>{
  const sel=document.querySelector('[name=raymap]');
  names.forEach(n=>{const o=document.createElement('option');o.textContent=n;sel.append(o);});});

// ---- minimal GLB point-cloud viewer (WebGL, zero deps) ----
let gl=null, prog=null, cloud=null, rot={x:-.4,y:.6}, dist=2.4, center=[0,0,0];
function initGL(){
  const c=document.getElementById('viewer');
  c.style.display='block'; c.width=c.clientWidth; c.height=480;
  gl=c.getContext('webgl');
  const vs=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
    varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);
    gl_PointSize=2.0;vc=col;}`;
  const fs=`precision mediump float;varying vec3 vc;
    void main(){gl_FragColor=vec4(vc,1.);}`;
  function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);
    gl.compileShader(h);return h;}
  prog=gl.createProgram();
  gl.attachShader(prog,sh(gl.VERTEX_SHADER,vs));
  gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fs));
  gl.linkProgram(prog); gl.useProgram(prog); gl.enable(gl.DEPTH_TEST);
  let drag=false,lx=0,ly=0;
  c.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
  window.onmouseup=()=>drag=false;
  window.onmousemove=e=>{if(!drag)return;
    rot.y+=(e.clientX-lx)*.008; rot.x+=(e.clientY-ly)*.008;
    lx=e.clientX; ly=e.clientY; draw();};
  c.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*.001);draw();};
}
function mat(){
  const a=gl.canvas.width/gl.canvas.height, f=1.6, n=.01, fa=100;
  const cx=Math.cos(rot.x),sx=Math.sin(rot.x),cy=Math.cos(rot.y),sy=Math.sin(rot.y);
  // row-major compose: persp * translate(0,0,-dist) * rotX * rotY * translate(-center)
  const R=[[cy,0,sy],[sx*sy,cx,-sx*cy],[-cx*sy,sx,cx*cy]];
  const m=new Float32Array(16);
  for(let i=0;i<3;i++){const r=R[i];
    m[i]=r[0]; m[4+i]=r[1]; m[8+i]=r[2];
    m[12+i]=-(r[0]*center[0]+r[1]*center[1]+r[2]*center[2]);}
  m[14]-=dist; m[15]=1;
  const p=new Float32Array(16);
  p[0]=f/a;p[5]=f;p[10]=(fa+n)/(n-fa);p[11]=-1;p[14]=2*fa*n/(n-fa);
  const o=new Float32Array(16);
  for(let c_=0;c_<4;c_++)for(let r_=0;r_<4;r_++){let s=0;
    for(let k=0;k<4;k++)s+=p[k*4+r_]*m[c_*4+k]; o[c_*4+r_]=s;}
  return o;
}
function draw(){
  if(!gl||!cloud)return;
  gl.viewport(0,0,gl.canvas.width,gl.canvas.height);
  gl.clearColor(.07,.07,.09,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,'mvp'),false,mat());
  gl.drawArrays(gl.POINTS,0,cloud.count);
}
async function showGLB(url){
  if(!gl)initGL();
  const buf=await (await fetch(url)).arrayBuffer();
  const dv=new DataView(buf);
  if(dv.getUint32(0,true)!==0x46546C67){console.error('not glb');return;}
  let off=12, json=null, bin=null;
  while(off<buf.byteLength){
    const len=dv.getUint32(off,true), type=dv.getUint32(off+4,true);
    const data=buf.slice(off+8,off+8+len);
    if(type===0x4E4F534A) json=JSON.parse(new TextDecoder().decode(data));
    else if(type===0x004E4942) bin=data;
    off+=8+len;
  }
  let pts=null;
  for(const mesh of json.meshes||[])
    for(const pr of mesh.primitives||[])
      if(pr.mode===0){pts=pr;break;}
  if(!pts){console.error('no point primitive');return;}
  const acc=i=>{const a=json.accessors[i],bv=json.bufferViews[a.bufferView];
    const o=(bv.byteOffset||0)+(a.byteOffset||0);
    return a.componentType===5126?new Float32Array(bin,o,a.count*3)
                                 :new Uint8Array(bin,o,a.count*3);};
  const pos=acc(pts.attributes.POSITION), col=acc(pts.attributes.COLOR_0);
  const pa=json.accessors[pts.attributes.POSITION];
  center=[0,1,2].map(i=>(pa.min[i]+pa.max[i])/2);
  dist=Math.max(pa.max[0]-pa.min[0],pa.max[1]-pa.min[1],pa.max[2]-pa.min[2])*1.5||2.4;
  const pb=gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER,pb);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  const lp=gl.getAttribLocation(prog,'p');
  gl.enableVertexAttribArray(lp); gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
  const cb=gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER,cb);
  gl.bufferData(gl.ARRAY_BUFFER,col,gl.STATIC_DRAW);
  const lc=gl.getAttribLocation(prog,'col');
  gl.enableVertexAttribArray(lc);
  gl.vertexAttribPointer(lc,3,gl.UNSIGNED_BYTE,true,0,0);
  cloud={count:pa.count};
  draw();
}

function renderProgress(s){
  const el=document.getElementById('progress');
  const bar=document.querySelector('#bar>div');
  if(s.status==='done'){el.firstChild.textContent='done';bar.style.width='100%';return;}
  if(s.status==='error'){el.firstChild.textContent='error: '+s.error;return;}
  const p=s.progress||{};
  let txt=s.status;
  if(p.detail)txt+=' — '+p.detail;
  if(p.stage)txt+=' ['+p.stage+']';
  el.firstChild.textContent=txt;
  if(p.frac!=null)bar.style.width=Math.round(p.frac*100)+'%';
}

document.getElementById('f').addEventListener('submit', async ev=>{
  ev.preventDefault();
  const log=document.getElementById('log');
  document.getElementById('progress').firstChild.textContent='submitting...';
  const res=await fetch('/api/submit',{method:'POST',body:new FormData(ev.target)});
  const {job_id,error}=await res.json();
  if(error){document.getElementById('progress').firstChild.textContent='error: '+error;return;}
  const poll=async()=>{
    const s=await (await fetch('/api/status/'+job_id)).json();
    log.textContent=JSON.stringify(s,null,2);
    renderProgress(s);
    if(s.status==='done'){
      const div=document.getElementById('artifacts'); div.innerHTML='';
      s.artifacts.forEach(a=>{const l=document.createElement('a');
        l.href=a;l.textContent=a;l.download='';div.append(l);});
      const glbs=s.artifacts.filter(a=>a.endsWith('.glb'));
      const sel=document.getElementById('frame_sel'); sel.innerHTML='';
      glbs.forEach(g=>{const o=document.createElement('option');
        o.value=g;o.textContent=g.split('/').pop();sel.append(o);});
      sel.onchange=()=>showGLB(sel.value);
      if(glbs.length)showGLB(glbs[0]);
    } else if(s.status!=='error') setTimeout(poll,1000);
  }; poll();});
</script></body></html>"""


def _job_shape(params: dict):
    """(height, width, num_frames, fps, steps, seed, raymap) of a job, with
    the server's defaults."""
    return (params.get("height", 480), params.get("width", 720),
            int(params.get("num_frames", 41)), int(params.get("fps", 12)),
            params.get("steps"), int(params.get("seed", 42)), params.get("raymap_array"))


def validate_job(pipeline, params: dict) -> None:
    """The pipeline's checks of a job before any rank runs it: the window
    the driver fits to the video (or the sampling call's inputs) through
    ``check_inputs``; raises ``ValueError`` with the pipeline's message."""
    from aether_tpu_torch.pipeline.windowing import fit_num_frames

    task = params["task"]
    height, width, num_frames, fps, _, _, raymap = _job_shape(params)
    if task == "reconstruction":
        video = params["video_array"]
        num_frames = fit_num_frames(len(video), num_frames, pipeline.config.allowed_num_frames)
        pipeline.check_inputs(task, None, video[:num_frames], None,
                              None if raymap is None else raymap[:num_frames],
                              height, width, num_frames, fps)
    else:
        pipeline.check_inputs(task, params["image_array"], None, params.get("goal_array"),
                              raymap, height, width, num_frames, fps)


def job_calls(pipeline, params: dict, progress=None):
    """A job's device calls, the same on every rank of a mesh and in the same
    order: for a reconstruction the window driver (the pipeline mesh's dp
    windows a ``batch_reconstruct`` chunk, JAX :352-361; one at a time
    without a mesh), else the sampling call and, unless
    ``post_reconstruction`` is off, the 4-step reconstruction of its RGB
    (reference demo.py:588-606). Returns the driver's ``(window_results,
    window_indices, num_frames)`` or ``(out, recon or None)``.
    ``progress(detail, frac)`` hears where it is."""
    from aether_tpu_torch.parallel.mesh import axis_size
    from aether_tpu_torch.pipeline.windowing import run_windowed_reconstruction

    def note(detail, frac):
        if progress is not None:
            progress(detail, frac)

    task = params["task"]
    height, width, num_frames, fps, steps, seed, raymap = _job_shape(params)
    if task == "reconstruction":
        return run_windowed_reconstruction(
            pipeline, params["video_array"], raymap=raymap, height=height, width=width,
            num_frames=num_frames, fps=fps, num_inference_steps=steps,
            stride=int(params.get("stride", 24)), seed=seed,
            batch_windows=axis_size(getattr(pipeline, "mesh", None), "dp"),
            progress=lambda done, total: note(f"window {done + 1}/{total}", 0.9 * done / total))
    note("sampling", 0.1)
    out = pipeline(
        task=task, image=params["image_array"], goal=params.get("goal_array"),
        raymap=raymap, height=height, width=width, num_frames=num_frames,
        fps=fps, num_inference_steps=steps, guidance_scale=params.get("cfg"),
        use_dynamic_cfg=params.get("dynamic_cfg", True), seed=seed)
    recon = None
    if params.get("post_reconstruction", True):
        note("post-reconstruction", 0.7)
        recon = pipeline(
            task="reconstruction", video=out.rgb, height=height, width=width,
            num_frames=num_frames, fps=fps, num_inference_steps=4,
            guidance_scale=1.0, use_dynamic_cfg=False, seed=seed)
    return out, recon


class MeshFailure(RuntimeError):
    """A job's device calls failed on some rank of a mesh: the server stops."""


class JobRunner:
    """One worker thread executing queued pipeline jobs. With a ``channel``
    (a :class:`~aether_tpu_torch.parallel.jobs.JobChannel`, on rank 0 of a
    mesh) it is the leader: each job is validated, broadcast, run by every
    rank, and exported here; ``close`` ends with the stop message. A failure of a job's device calls, here or on a
    follower, ends that job in ``error``, records :attr:`failed`, calls
    ``on_fatal`` and stops the worker: the mesh is broken."""

    def __init__(self, pipeline, output_dir: str, max_queue: int = 20,
                 max_jobs_kept: int = 100, *, channel=None, on_fatal=None):
        self.pipeline = pipeline
        self.output_dir = output_dir
        self.max_jobs_kept = max_jobs_kept
        self.jobs: Dict[str, dict] = {}
        self._lock = threading.Lock()  # guards self.jobs and every job's fields
        self.queue: "queue.Queue[str]" = queue.Queue(maxsize=max_queue)
        self.channel = channel
        self.on_fatal = on_fatal
        self.failed: Optional[str] = None
        if channel is not None:
            channel.on_error = lambda exc: self._fatal(f"the job channel failed: {exc}")
        # a thread's current CUDA device is its own: the worker makes the
        # pipeline's current, and where the pipeline names no index, the
        # one current on the thread that builds the runner
        device = torch.device(pipeline.device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._closing = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, params: dict) -> str:
        job_id = uuid.uuid4().hex[:12]
        entry = {"status": "queued", "params": params, "artifacts": [],
                 "progress": {"stage": None, "detail": "", "frac": 0.0,
                              "stages_done": []}}
        with self._lock:
            self.jobs[job_id] = entry
            try:
                self.queue.put_nowait(job_id)  # raises queue.Full when saturated
            except queue.Full:
                del self.jobs[job_id]  # don't leak a zombie 'queued' entry
                raise
            # evict the oldest finished jobs beyond the cap (dicts keep order)
            finished = [jid for jid, j in self.jobs.items()
                        if j["status"] in ("done", "error")]
            for jid in finished[:max(0, len(self.jobs) - self.max_jobs_kept)]:
                del self.jobs[jid]
        return job_id

    def status(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                return None
            return copy.deepcopy({"status": job["status"], "artifacts": job["artifacts"],
                                  "error": job.get("error"), "progress": job.get("progress")})

    def counts(self) -> Dict[str, int]:
        """Jobs by status."""
        with self._lock:
            by_status: Dict[str, int] = {}
            for job in self.jobs.values():
                by_status[job["status"]] = by_status.get(job["status"], 0) + 1
        return by_status

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the worker after the jobs queued before this call and join
        it, so that it lets go of the pipeline (and its device memory);
        a leader's worker sends the stop message last. ``timeout`` bounds
        the wait."""
        self._closing.set()
        self._thread.join(timeout)

    def _update(self, job_id: str, **progress) -> None:
        with self._lock:
            self.jobs[job_id]["progress"].update(progress)

    def _fatal(self, reason: str) -> None:
        """The mesh is broken: the jobs still queued end in ``error`` and
        ``on_fatal`` is told."""
        self.failed = reason
        print(f"the server stops: {reason}", file=sys.stderr, flush=True)
        with self._lock:
            for job in self.jobs.values():
                if job["status"] == "queued":
                    job.update(status="error", error=f"the server stopped: {reason}",
                               params=None)
        if self.on_fatal is not None:
            self.on_fatal()

    def _worker(self) -> None:
        from aether_tpu_torch.utils.profiling import add_stage_listener, remove_stage_listener

        setup_error = None
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
        except Exception as exc:  # noqa: BLE001 -- reported on every job instead
            setup_error = f"the worker could not make {self.device} current: {exc}"
            print(setup_error, file=sys.stderr, flush=True)
        while True:
            try:
                job_id = self.queue.get(timeout=0.1)
            except queue.Empty:
                if self._closing.is_set():  # close(), the queue drained
                    if self.channel is not None and self.failed is None:
                        try:
                            self.channel.stop()
                        except Exception as exc:  # noqa: BLE001 -- a follower is gone
                            self._fatal(f"the stop message failed: {exc}")
                    return
                if self.failed is not None:  # the channel failed between jobs
                    return
                continue
            with self._lock:
                job = self.jobs[job_id]
                if setup_error is not None:
                    job["status"] = "error"
                    job["error"] = setup_error
                    job["params"] = None
                    continue
                job["status"] = "running"
                prog = job["progress"]
                params = job["params"]

            # live per-stage progress: the pipeline's stage timers mark the
            # vae_encode / denoise / vae_decode boundaries (the reference's
            # staged gr.Progress, demo_gradio.py:490,507,536)
            def on_stage(name, event, seconds, _p=prog):
                with self._lock:
                    if event == "begin":
                        _p["stage"] = name
                    elif event == "progress":
                        # a sub-stage fraction (one event a denoise step):
                        # live detail, not a finished stage
                        _p["stage"] = f"{name} {int(seconds * 100)}%"
                    else:
                        _p["stage"] = None
                        _p["stages_done"].append({"stage": name,
                                                  "seconds": round(seconds, 3)})

            add_stage_listener(on_stage)
            fatal = None
            try:
                artifacts = self._run(job_id, params)
                with self._lock:
                    job["artifacts"] = artifacts
                    job["status"] = "done"
                    prog["frac"] = 1.0
            except Exception as exc:  # noqa: BLE001 -- a failed job must not stop the worker
                with self._lock:
                    job["status"] = "error"
                    job["error"] = f"{exc}"
                    job["trace"] = traceback.format_exc()
                if isinstance(exc, MeshFailure):
                    fatal = f"job {job_id}: {exc}"
            finally:
                remove_stage_listener(on_stage)
                with self._lock:
                    job["params"] = None  # drop the pixel arrays once finished
            if fatal is not None:
                self._fatal(fatal)
                return

    def _run(self, job_id: str, params: dict) -> list:
        def progress(detail, frac):
            self._update(job_id, detail=detail, frac=frac)

        if self.channel is None:
            results = job_calls(self.pipeline, params, progress)
        else:
            # a job the pipeline refuses never reaches a follower
            validate_job(self.pipeline, params)
            try:
                self.channel.send_job(params)
                results = job_calls(self.pipeline, params, progress)
            except Exception as exc:
                raise MeshFailure(f"the device calls failed: {exc}") from exc
            try:
                self.channel.job_done()
            except Exception as exc:
                raise MeshFailure(f"a follower failed in the device calls: {exc}") from exc
        return self._export(job_id, params, results)

    def _export(self, job_id: str, params: dict, results) -> list:
        """Rank 0's host part of a job: blend the windows, write the
        artifacts; returns their URLs."""
        from aether_tpu_torch.apps.demo import save_output
        from aether_tpu_torch.pipeline.windowing import blend_and_merge_window_results

        task = params["task"]
        job_dir = os.path.join(self.output_dir, job_id)
        os.makedirs(job_dir, exist_ok=True)
        dev = self.device
        height, width = params.get("height", 480), params.get("width", 720)
        ns = argparse.Namespace(
            task=task, output_dir=job_dir, height=height, width=width,
            max_depth=float(params.get("max_depth", 100.0)),
            rtol=float(params.get("rtol", 0.2)),
            smooth_camera=params.get("smooth_camera", True),
            smooth_method=params.get("smooth_method", "kalman"),
            align_pointmaps=params.get("align_pointmaps", False),
            pointcloud_save_frame_interval=int(params.get("pc_interval", 10)),
            video="upload.mp4", image="upload.png", goal="goal.png",
        )

        if task == "reconstruction":
            window_results, window_indices, _ = results
            self._update(job_id, detail="blending windows", frac=0.9)
            rgb, disparity, poses, pointmaps = blend_and_merge_window_results(
                window_results, window_indices, height, width,
                smooth_camera=ns.smooth_camera, smooth_method=ns.smooth_method,
                align_pointmaps=ns.align_pointmaps, device=dev)
            self._update(job_id, detail="exporting artifacts", frac=0.95)
            written = save_output(rgb, disparity, ns, poses=poses, pointmap=pointmaps,
                                  device=dev)
        else:
            out, recon = results
            disparity, out_raymap = (recon or out).disparity, (recon or out).raymap
            self._update(job_id, detail="exporting artifacts", frac=0.95)
            written = save_output(out.rgb, disparity, ns, raymap=out_raymap, device=dev)

        artifacts = []
        for value in written.values():
            for path in value if isinstance(value, list) else [value]:
                rel = os.path.relpath(path, self.output_dir)
                artifacts.append(f"/outputs/{rel}")
        return artifacts


def follow(pipeline, channel) -> int:
    """A follower's loop: each job the leader broadcasts goes through
    :func:`job_calls` (outputs dropped, no stage listeners), then
    ``channel.job_done()``; returns the number of jobs at the stop message.
    A failure propagates at once, without ``job_done``: the rank leaves, and
    the others find it gone."""
    device = torch.device(pipeline.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    while True:
        params = channel.receive()
        if params is None:
            return channel.jobs
        job_calls(pipeline, params)
        channel.job_done()


def serve(pipeline, output_dir: str, *, host: str = "127.0.0.1", port: int = 7860,
          raymap_dir: Optional[str] = None, max_queue: int = 20, channel=None,
          on_listen=None) -> None:
    """Serve ``pipeline`` until the HTTP server shuts down. Without a
    ``channel``, one process. With one: a follower runs :func:`follow`; the
    leader serves with a leader :class:`JobRunner`, turns SIGTERM into a
    clean stop (from the main thread), closes the runner (the stop message)
    and leaves the process group with every rank; it raises
    :class:`MeshFailure` when a job broke the mesh. ``on_listen(server,
    runner)`` is called once the leader listens."""
    import torch.distributed as dist

    from aether_tpu_torch.parallel import is_main

    if channel is not None and not channel.is_leader:
        if threading.current_thread() is threading.main_thread():
            # a launcher's SIGTERM reaches every rank: a follower leaves at
            # the leader's stop message, which keeps the collectives matched
            signal.signal(signal.SIGTERM, lambda *_: None)
        follow(pipeline, channel)
        dist.destroy_process_group()
        return
    os.makedirs(output_dir, exist_ok=True)
    server = None

    def shutdown():
        threading.Thread(target=server.shutdown, daemon=True).start()

    runner = JobRunner(pipeline, output_dir, max_queue=max_queue, channel=channel,
                       on_fatal=shutdown)
    server = ThreadingHTTPServer((host, port), make_handler(runner, raymap_dir))
    if channel is not None and threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: shutdown())
    if is_main():
        print(f"serving on http://{host}:{server.server_address[1]}", flush=True)
    if on_listen is not None:
        on_listen(server, runner)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        if channel is None:
            raise
    finally:
        server.server_close()
    if channel is None:
        return
    runner.close()
    if runner.failed is not None:
        raise MeshFailure(runner.failed)
    dist.destroy_process_group()


MAX_UPLOAD_BYTES = 512 * 1024 * 1024  # bound what one POST may allocate


def _parse_multipart(handler: BaseHTTPRequestHandler) -> dict:
    """Minimal multipart/form-data parser (fields + file payloads)."""
    import email
    import email.policy

    length = int(handler.headers.get("Content-Length", 0))
    if length > MAX_UPLOAD_BYTES:
        raise ValueError(f"upload too large ({length} bytes > {MAX_UPLOAD_BYTES})")
    body = handler.rfile.read(length)
    content_type = handler.headers.get("Content-Type", "")
    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP)
    fields: dict = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        payload = part.get_payload(decode=True)
        filename = part.get_filename()
        if filename:
            if payload:
                fields[name] = {"filename": filename, "data": payload}
        else:
            fields[name] = payload.decode("utf-8", "replace").strip()
    return fields


def make_handler(runner: JobRunner, raymap_dir: Optional[str]):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, data: bytes, content_type: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(_INDEX_HTML.encode(), "text/html; charset=utf-8")
            elif self.path == "/api/raymaps":
                # canned .npy blobs (with a --raymap_dir) and the generated
                # actions: submit takes both, so the listing names both
                from aether_tpu_torch.apps.actions import NAMED_ACTIONS

                names = set(NAMED_ACTIONS)
                if raymap_dir and os.path.isdir(raymap_dir):
                    names |= {os.path.splitext(f)[0].replace("raymap_", "")
                              for f in os.listdir(raymap_dir) if f.endswith(".npy")}
                self._json(sorted(names))
            elif self.path == "/api/stats":
                # queue depth, jobs by status, accumulated stage wall-clock
                from aether_tpu_torch.utils.profiling import stage_report

                self._json({"queue_depth": runner.queue.qsize(), "jobs": runner.counts(),
                            "stages": stage_report()})
            elif self.path.startswith("/api/status/"):
                status = runner.status(self.path.rsplit("/", 1)[-1])
                if status is None:
                    self._json({"error": "unknown job"}, 404)
                else:
                    self._json(status)
            elif self.path.startswith("/outputs/"):
                root = os.path.realpath(runner.output_dir)
                full = os.path.realpath(
                    os.path.join(root, self.path[len("/outputs/"):].lstrip("/")))
                # containment: the real path must stay under the output root
                # (normpath alone misses absolute paths and symlinks)
                if not full.startswith(root + os.sep) or not os.path.isfile(full):
                    self._json({"error": "not found"}, 404)
                    return
                with open(full, "rb") as f:
                    data = f.read()
                self._send(data, "application/octet-stream")
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/api/submit":
                self._json({"error": "not found"}, 404)
                return
            try:
                fields = _parse_multipart(self)
                params = _fields_to_params(fields, raymap_dir)
                job_id = runner.submit(params)
                self._json({"job_id": job_id})
            except queue.Full:
                self._json({"error": f"queue full (max {runner.queue.maxsize})"}, 429)
            except Exception as exc:  # noqa: BLE001 -- a bad request answers 400
                self._json({"error": str(exc)}, 400)

    return Handler


def _decode_image(file_field: dict) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(file_field["data"])).convert("RGB"))


def _decode_video(file_field: dict) -> np.ndarray:
    import imageio.v3 as iio

    ext = os.path.splitext(file_field["filename"])[1] or ".mp4"
    return np.asarray(iio.imread(file_field["data"], extension=ext)).astype(np.float32) / 255.0


def _fields_to_params(fields: dict, raymap_dir: Optional[str]) -> dict:
    task = fields.get("task")
    if task not in ("reconstruction", "prediction", "planning"):
        raise ValueError(f"invalid task {task!r}")
    params: dict = {"task": task}
    for key in ("num_frames", "fps", "stride", "height", "width", "seed", "pc_interval"):
        if fields.get(key):
            params[key] = int(fields[key])
    if fields.get("steps"):
        params["steps"] = int(fields["steps"])
    for key in ("cfg", "max_depth", "rtol"):
        if fields.get(key):
            params[key] = float(fields[key])
    # tri-state: absent/"" -> task default (None); "on"/"off" -> forced
    if fields.get("dynamic_cfg") in ("on", "off"):
        params["dynamic_cfg"] = fields["dynamic_cfg"] == "on"
    for key, default in (("post_reconstruction", True), ("smooth_camera", True),
                         ("align_pointmaps", False)):
        val = fields.get(key)
        params[key] = default if val in (None, "") else val == "yes"
    if fields.get("smooth_method"):
        if fields["smooth_method"] not in ("kalman", "gaussian", "savgol", "ma"):
            raise ValueError(f"unknown smooth_method {fields['smooth_method']!r}")
        params["smooth_method"] = fields["smooth_method"]
    if task == "reconstruction":
        if "video" not in fields:
            raise ValueError("reconstruction requires a video upload")
        params["video_array"] = _decode_video(fields["video"])
    else:
        if "image" not in fields:
            raise ValueError(f"{task} requires an image upload")
        params["image_array"] = _decode_image(fields["image"])
        if task == "planning":
            if "goal" not in fields:
                raise ValueError("planning requires a goal image upload")
            params["goal_array"] = _decode_image(fields["goal"])
    name = fields.get("raymap")
    if name:
        path = (os.path.join(raymap_dir, f"raymap_{name}.npy")
                if raymap_dir else None)  # never resolve relative to the CWD
        if path and os.path.isfile(path):
            params["raymap_array"] = np.load(path)
        else:
            from aether_tpu_torch.apps.actions import NAMED_ACTIONS, action_raymap

            if name not in NAMED_ACTIONS:
                raise ValueError(f"unknown raymap action {name!r}")
            # reconstruction slices the raymap per sliding window, so the
            # generated action spans the WHOLE video, not one window
            if task == "reconstruction":
                length = len(params["video_array"])
            else:
                length = int(params.get("num_frames", 41))
            params["raymap_array"] = action_raymap(
                name, num_frames=length, height=int(params.get("height", 480)),
                width=int(params.get("width", 720)))
    return params


def warmup(pipeline, tasks, num_frames: int = 41, height: int = 480,
           width: int = 720, steps: Optional[int] = None) -> None:
    """Run each named task once on zeros at the given shape before serving
    (``steps=None`` keeps the task defaults: 4 reconstruction, 50 prediction
    and planning). The port compiles nothing per shape; the first request
    builds the kernels (``ops/_build.py``) and warms cuDNN's algorithm
    choice and the allocator, which the warmup takes off the first user's
    request. Each task is timed as the stage ``warmup/<task>``."""
    from aether_tpu_torch.utils.profiling import stage_timer

    video = np.zeros((num_frames, height, width, 3), np.uint8)
    image = np.zeros((height, width, 3), np.uint8)
    for task in tasks:
        kw = dict(task=task, height=height, width=width, num_frames=num_frames,
                  fps=12, seed=0, num_inference_steps=steps)
        with stage_timer(f"warmup/{task}"):
            if task == "reconstruction":
                pipeline(video=video, guidance_scale=1.0, use_dynamic_cfg=False, **kw)
            elif task == "prediction":
                pipeline(image=image, **kw)
            elif task == "planning":
                pipeline(image=image, goal=image, **kw)
            else:
                raise ValueError(f"unknown warmup task {task!r}")


def parse_args(argv=None) -> argparse.Namespace:
    from aether_tpu_torch.apps.demo import RANDOM_INITS

    p = argparse.ArgumentParser(description="Aether web server (PyTorch)")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--output_dir", type=str, default="serve_outputs")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Converted checkpoint directory (aether_tpu_torch.io.convert).")
    p.add_argument("--config", type=str, default="aetherv1", choices=["aetherv1", "tiny"],
                   help="Model topology of --checkpoint.")
    p.add_argument("--random-init", dest="random_init", type=str, default=None,
                   choices=RANDOM_INITS,
                   help="Seeded random weights instead of a checkpoint (as apps/demo.py).")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to run on (default cuda; cpu only when asked).")
    p.add_argument("--raymap_dir", type=str, default=None,
                   help="Directory of canned raymap_<name>.npy actions.")
    p.add_argument("--max_queue", type=int, default=20,
                   help="Job queue bound (reference demo.queue(max_size=20)).")
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh axis for serving (the CFG pair and "
                        "batched windows ride it); one process per card under torchrun.")
    p.add_argument("--tp", type=int, default=None,
                   help="Tensor-parallel mesh axis (Megatron DiT split); one process "
                        "per card under torchrun.")
    p.add_argument("--warmup", nargs="*", default=None,
                   choices=["reconstruction", "prediction", "planning"], metavar="TASK",
                   help="Run these tasks once on zeros before listening.")
    p.add_argument("--warmup_shape", nargs=3, type=int, default=(41, 480, 720),
                   metavar=("FRAMES", "HEIGHT", "WIDTH"))
    p.add_argument("--warmup_steps", type=int, default=None,
                   help="Denoise steps for the warmup (default: the task defaults).")
    p.add_argument("--wire_rgb", type=str, default=None, choices=["u8", "yuv420"],
                   help="compact D2H rgb wire format (default: u8 on a card)")
    p.add_argument("--wire_input", type=str, default="u8", choices=["u8", "yuv420"],
                   help="H2D pixel wire (yuv420: 1.5 bytes a pixel)")
    p.add_argument("--wire_disparity", type=str, default="fp16", choices=["fp16", "u8"],
                   help="compact D2H disparity wire (u8 = sqrt-domain 8-bit)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    from aether_tpu_torch.apps.demo import build_mesh, build_pipeline
    from aether_tpu_torch.parallel import is_main
    from aether_tpu_torch.parallel.jobs import JobChannel

    args = parse_args(argv)
    mesh = build_mesh(args)
    pipeline, _ = build_pipeline(args, mesh)
    channel = None if mesh is None else JobChannel()
    if args.warmup:  # every rank: the warmup calls run over the mesh too
        f, h, w = args.warmup_shape
        if is_main():
            print(f"warming up {args.warmup} at {f}f x {h}x{w} ...", flush=True)
        warmup(pipeline, args.warmup, num_frames=f, height=h, width=w,
               steps=args.warmup_steps)
    serve(pipeline, args.output_dir, host=args.host, port=args.port,
          raymap_dir=args.raymap_dir, max_queue=args.max_queue, channel=channel)


if __name__ == "__main__":
    main()
