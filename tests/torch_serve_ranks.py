"""Rank-side helpers of ``tests/test_torch_serve_mesh.py``.

:func:`serve_rank` runs on each spawned gloo rank (``parallel.launch``): it
builds the port's tiny pipeline over the mesh a case names, wraps it so
that every call draws from a table of the JAX key streams' draws
(:class:`TableNoise`) and is recorded, and serves it through
``apps.serve.serve`` with a job channel of a short timeout. Rank 0's client
thread submits the case's jobs over HTTP, polls them, idles where asked and
shuts the server down; every rank returns what it saw.
"""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import torch

FORM = {"num_frames": "17", "height": "64", "width": "96", "steps": "1"}


def jobs():
    """The tests' jobs as (form fields, uploads): a two-window
    reconstruction (25 frames, windows of 17 at stride 8), a prediction
    with a generated raymap and the post-reconstruction, and the same
    prediction without it."""
    from test_torch_serve import gif_bytes, png_bytes

    recon = (dict(FORM, task="reconstruction", stride="8", seed="11"),
             {"video": ("clip.gif", gif_bytes(25))})
    pred = (dict(FORM, task="prediction", seed="5", raymap="left"),
            {"image": ("image.png", png_bytes(3))})
    return recon, pred, (dict(pred[0], post_reconstruction="no"), pred[1])


class TableNoise:
    """The JAX key streams' draws of one seed, looked up by (seed, kind,
    shape) in a table recorded in the pytest process, so that every rank
    (and the one-process server) sees the JAX job's noise without jax."""

    def __init__(self, table, seed):
        self.table, self.seed = table, seed

    def _get(self, kind, shape):
        return self.table[(self.seed, kind, tuple(shape))].clone()

    def posterior(self, shape):
        return self._get("posterior", shape)

    def goal(self, shape):
        return self._get("goal", shape)

    def initial(self, shape):
        return self._get("initial", shape)

    def sde(self, step, shape):
        return self._get(f"sde{step}", shape)


class RecordingJaxNoise:
    """``JaxKeyNoise`` writing each draw into ``table`` (the pytest
    process's side of :class:`TableNoise`)."""

    def __init__(self, table, seed):
        from test_torch_pipeline import JaxKeyNoise

        self.table, self.seed, self.inner = table, seed, JaxKeyNoise(seed)

    def _keep(self, kind, shape, draw):
        self.table[(self.seed, kind, tuple(shape))] = draw.clone()
        return draw

    def posterior(self, shape):
        return self._keep("posterior", shape, self.inner.posterior(shape))

    def goal(self, shape):
        return self._keep("goal", shape, self.inner.goal(shape))

    def initial(self, shape):
        return self._keep("initial", shape, self.inner.initial(shape))

    def sde(self, step, shape):
        return self._keep(f"sde{step}", shape, self.inner.sde(step, shape))


class DrawsPipeline:
    """A pipeline whose every call passes ``noise=make_noise(seed)`` and is
    recorded as (method, task, frames, deferred); ``fail`` raises inside the
    first call (a rank failing in a job's device calls)."""

    def __init__(self, pipe, make_noise, fail: bool = False):
        self.pipe, self.make_noise, self.fail = pipe, make_noise, fail
        self.config, self.device = pipe.config, pipe.device
        self.mesh = getattr(pipe, "mesh", None)
        self.check_inputs = pipe.check_inputs
        self.calls = []

    def _enter(self, method, kw, frames):
        self.calls.append((method, kw.get("task", "reconstruction"), frames,
                           bool(kw.get("defer_host"))))
        if self.fail:
            raise RuntimeError("injected failure inside a job's device calls")
        return dict(kw, noise=self.make_noise(kw["seed"]))

    def __call__(self, **kw):
        video = kw.get("video")
        return self.pipe(**self._enter("__call__", kw, None if video is None else len(video)))

    def batch_reconstruct(self, videos, **kw):
        kw = self._enter("batch_reconstruct", kw, tuple(np.asarray(videos).shape[:2]))
        return self.pipe.batch_reconstruct(videos, **kw)


class SavedOutputs:
    """Wraps a demo module's ``save_output``: keeps each export's rgb and
    disparity and returns what the original writes; ``install`` puts it in
    the module's place."""

    def __init__(self, module, install: bool = True):
        self.original, self.calls, self.dirs = module.save_output, [], []
        self._lock = threading.Lock()
        if install:
            module.save_output = self

    def __call__(self, rgb, disparity, args, **kw):
        with self._lock:  # runners on several threads
            self.calls.append((np.array(rgb), np.array(disparity)))
            self.dirs.append(args.output_dir)
        return self.original(rgb, disparity, args, **kw)


def submit(base, job):
    """POST one job (fields and upload bytes) to ``/api/submit``."""
    from test_torch_serve import multipart

    fields, files = job
    data, content_type = multipart(fields, files)
    req = urllib.request.Request(base + "/api/submit", data=data,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())["job_id"]


def wait(base, job_id, seconds=240):
    for _ in range(seconds * 10):
        with urllib.request.urlopen(f"{base}/api/status/{job_id}", timeout=30) as r:
            status = json.loads(r.read())
        if status["status"] in ("done", "error"):
            return status
        time.sleep(0.1)
    raise AssertionError(f"job {job_id} did not finish")


def poses_of(output_dir, status):
    path = next(a for a in status["artifacts"] if a.endswith("_poses.txt"))
    return np.loadtxt(os.path.join(output_dir, path[len("/outputs/"):]))


def build_pipeline(states, text, mesh=None):
    """The tiny port pipeline (f32, CPU) on the given weights."""
    from aether_tpu_torch.config import PipelineConfig
    from aether_tpu_torch.models.dit import DiT
    from aether_tpu_torch.models.vae import VAE
    from aether_tpu_torch.pipeline import AetherPipeline

    cfg = PipelineConfig.tiny()
    dit, vae = DiT(cfg.dit), VAE(cfg.vae)
    dit.load_state_dict(states["dit"])
    vae.load_state_dict(states["vae"])
    return AetherPipeline(cfg, dit, vae, text, device="cpu", compute_dtype=torch.float32,
                          mesh=mesh)


def serve_rank(states, text, table, axes, jobs, output_dir, timeout=6.0, keepalive=1.0,
               idle_after=(), fail_rank=None):
    """One rank of a two-rank server over the ('dp', 'tp') mesh ``axes``.
    Rank 0 serves and its client thread submits ``jobs`` over HTTP (sleeping
    ``idle_after[i]`` seconds after job i where given) and then shuts the
    server down; ``fail_rank`` raises in its first pipeline call. The draws
    come from ``table`` (:class:`TableNoise`), or with None from
    ``JaxKeyNoise`` on the rank. Returns {calls, jobs (the channel's count),
    statuses, poses, saved}."""
    from aether_tpu_torch.apps import demo, serve
    from aether_tpu_torch.parallel import initialize, make_mesh
    from aether_tpu_torch.parallel.jobs import JobChannel

    torch.set_num_threads(1)
    initialize(device="cpu")
    rank = torch.distributed.get_rank()
    if table is None:  # the JAX key streams drawn here
        from test_torch_pipeline import JaxKeyNoise as make_noise
    else:
        def make_noise(seed):
            return TableNoise(table, seed)
    pipe = DrawsPipeline(build_pipeline(states, text, make_mesh(**axes)), make_noise,
                         fail=rank == fail_rank)
    channel = JobChannel(timeout=timeout, keepalive=keepalive)
    saved = SavedOutputs(demo)
    out = dict(statuses=[], poses=[], runner=None)

    def client(server, runner):
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for i, job in enumerate(jobs):
                status = wait(base, submit(base, job))
                out["statuses"].append(status)
                if status["status"] == "done":
                    out["poses"].append(poses_of(output_dir, status))
                time.sleep(dict(enumerate(idle_after)).get(i, 0.0))
        except Exception as exc:  # noqa: BLE001 -- the server stopped under the client
            out["client_error"] = repr(exc)
        finally:
            server.shutdown()

    def on_listen(server, runner):
        out["runner"] = runner
        threading.Thread(target=client, args=(server, runner), daemon=True).start()

    try:
        serve.serve(pipe, output_dir, port=0, channel=channel, on_listen=on_listen)
    except serve.MeshFailure:
        runner = out["runner"]
        print("statuses:", json.dumps({j: runner.status(j)["status"] for j in runner.jobs}),
              flush=True)
        raise
    return dict(calls=pipe.calls, jobs=channel.jobs, statuses=out["statuses"],
                poses=out["poses"], saved=saved.calls, client_error=out.get("client_error"))


def params_of(job):
    """A job's params as the server's HTTP handler makes them."""
    from aether_tpu_torch.apps import serve

    fields, files = job
    return serve._fields_to_params(
        dict(fields, **{k: {"filename": n, "data": d} for k, (n, d) in files.items()}), None)


def wait_runner(runner, job_id, seconds=300):
    """A job's status on a runner in this process once it ends."""
    for _ in range(seconds * 10):
        status = runner.status(job_id)
        if status["status"] in ("done", "error"):
            return status
        time.sleep(0.1)
    raise AssertionError(f"job {job_id} did not finish")


def run_in_process(runner, jobs, output_dir):
    """``jobs`` on a runner in this process: (statuses, poses), all done."""
    statuses = [wait_runner(runner, runner.submit(params_of(job))) for job in jobs]
    assert all(s["status"] == "done" for s in statuses), [s.get("error") for s in statuses]
    return statuses, [poses_of(output_dir, s) for s in statuses]


def serve_one_process(pipe, jobs, output_dir, table):
    """``jobs`` on the one-process port server over ``pipe`` with the JAX
    key streams' draws, recorded into ``table``: {saved, poses}."""
    from aether_tpu_torch.apps import demo, serve

    saved = SavedOutputs(demo)
    try:
        runner = serve.JobRunner(
            DrawsPipeline(pipe, lambda seed: RecordingJaxNoise(table, seed)), str(output_dir))
        _, poses = run_in_process(runner, jobs, str(output_dir))
        runner.close()
    finally:
        demo.save_output = saved.original
    return dict(saved=saved.calls, poses=poses)


def start_ranks(pipe, table, axes, jobs, output_dir, **kw):
    """Two ranks of :func:`serve_rank` on the pipeline's weights."""
    from aether_tpu_torch.parallel.launch import start

    here = os.path.dirname(os.path.abspath(__file__))
    states = {"dit": pipe.dit.state_dict(), "vae": pipe.vae.state_dict()}
    return start("torch_serve_ranks:serve_rank", 2, dict(
        states=states, text=pipe.empty_prompt_embeds.numpy(), table=table, axes=axes,
        jobs=jobs, output_dir=str(output_dir), **kw), extra_path=[here],
        env={"OMP_NUM_THREADS": "1"})
