"""The port's server over a mesh: a leader and a follower on two gloo ranks
(CPU, tiny config, f32).

Rank 0 serves HTTP (``apps.serve.serve`` with a ``parallel.jobs.JobChannel``
of a short timeout); its client thread submits the jobs over HTTP and polls
them. Every pipeline call on every rank draws the JAX key streams' noise (a
table recorded from ``JaxKeyNoise`` in this process while the one-process
server ran, ``torch_serve_ranks.TableNoise``). Cases:

- dp = 2 and tp = 2: a two-window reconstruction job (one
  ``batch_reconstruct`` chunk at dp = 2, two windows one after the other at
  tp = 2) and a prediction job (CFG, a generated raymap, the 4-step
  post-reconstruction): the exported rgb and disparity and the saved poses
  within 2e-4 of the one-process port server's (the disparity 1e-4
  relative on top, ``DISP_RTOL``); the follower made the same pipeline
  calls as the leader (the JAX ``JobRunner`` on the same mesh is
  ``test_torch_serve_mesh_jax.py``'s);
- a job the pipeline's ``check_inputs`` refuses ends in ``error`` on rank 0
  and reaches no follower; after the leader idles past the channel's
  timeout (6 s) the server still serves (the same reconstruction again,
  bit-identical);
- a follower that raises inside a job's device calls: the job ends in
  ``error`` and both ranks exit non-zero on their own, well inside the
  test's limit;
- ``python -m aether_tpu_torch.apps.serve --device cpu --random-init tiny
  --dp 2`` on two processes with torchrun's variables answers one job, and
  SIGTERM to rank 0 stops both ranks with exit code 0.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import free_port
from test_torch_parallel_dit import ENV, HERE
from test_torch_serve import gif_bytes
from torch_serve_ranks import jobs, serve_one_process, start_ranks, submit, wait

torch.set_num_threads(1)

TIMEOUT, KEEPALIVE, IDLE = 6.0, 1.0, 8.0
# the disparity squares the decoded value (up to ~3.5 here), and the
# prediction job's post-reconstruction runs on the tp-rounded RGB: at tp = 2
# one of 104448 values of 3.46 was 2.02e-4 off, hence 1e-4 relative on top
DISP_RTOL = 1e-4
RECON, PRED, _ = jobs()
REFUSED = (dict(RECON[0], height="60"), RECON[1])  # check_inputs: not divisible by 8
CASES = {
    "dp2": dict(axes=dict(dp=2, tp=1), jobs=[RECON, PRED, REFUSED, RECON],
                idle_after=(0.0, 0.0, IDLE)),
    "tp2": dict(axes=dict(dp=1, tp=2), jobs=[RECON, PRED]),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The one-process port server's jobs (recording the draws table) and
    the two meshes' ranks."""
    from test_torch_batch_reconstruct import tiny_pipelines

    port = tiny_pipelines()[-1]
    table = {}
    one = serve_one_process(port, [RECON, PRED], tmp_path_factory.mktemp("one"), table)
    ranks = {name: start_ranks(port, table, case["axes"], case["jobs"],
                               tmp_path_factory.mktemp(name), timeout=TIMEOUT,
                               keepalive=KEEPALIVE, idle_after=case.get("idle_after", ()))
             for name, case in CASES.items()}
    return dict(one=one, port=port, table=table,
                ranks={name: r.join(timeout=240) for name, r in ranks.items()})


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_jobs_match_one_process(setup, name):
    leader, follower = setup["ranks"][name]
    assert leader["client_error"] is None, leader["client_error"]
    assert [s["status"] for s in leader["statuses"][:2]] == ["done", "done"]
    one = setup["one"]
    for i, what in enumerate(("reconstruction", "prediction")):
        (rgb, disp), (ref_rgb, ref_disp) = leader["saved"][i], one["saved"][i]
        np.testing.assert_allclose(rgb, ref_rgb, atol=2e-4, err_msg=f"{name} {what} rgb")
        np.testing.assert_allclose(disp, ref_disp, rtol=DISP_RTOL, atol=2e-4,
                                   err_msg=f"{name} {what} disp")
        np.testing.assert_allclose(leader["poses"][i], one["poses"][i], atol=2e-4,
                                   err_msg=f"{name} {what} poses")
    # the follower: the same calls, in the same order, its outputs dropped
    assert follower["calls"] == leader["calls"] and follower["saved"] == []
    # the window driver defers; the sampling call and the post-reconstruction
    # do not; dp = 2 batches the two windows into one chunk
    windows = ([("batch_reconstruct", "reconstruction", (2, 17), True)] if name == "dp2"
               else [("__call__", "reconstruction", 17, True)] * 2)
    assert leader["calls"][:len(windows) + 2] == windows + [
        ("__call__", "prediction", None, False), ("__call__", "reconstruction", 17, False)]


def test_refused_job_reaches_no_follower_and_idle_server_serves(setup):
    leader, follower = setup["ranks"]["dp2"]
    assert [s["status"] for s in leader["statuses"]] == ["done", "done", "error", "done"]
    assert "divisible by 8" in leader["statuses"][2]["error"]
    # three jobs broadcast and received; the refused one never left rank 0
    assert leader["jobs"] == follower["jobs"] == 3
    assert IDLE > TIMEOUT  # the leader idled past the channel's timeout
    for a, b in zip(leader["saved"][2], leader["saved"][0]):
        np.testing.assert_array_equal(a, b)


def test_follower_failure_ends_the_job_and_every_rank(setup, tmp_path):
    t0 = time.monotonic()
    ranks = start_ranks(setup["port"], setup["table"], dict(dp=2, tp=1), [RECON], tmp_path,
                        timeout=TIMEOUT, keepalive=KEEPALIVE, fail_rank=1)
    with pytest.raises(RuntimeError) as err:
        ranks.join(timeout=120)
    report = str(err.value)
    assert time.monotonic() - t0 < 110, "a rank hung until the test's limit"
    assert "--- rank 0 (exit 1) ---" in report and "--- rank 1 (exit 1) ---" in report, report
    assert "injected failure" in report
    statuses = json.loads(report.split("statuses: ", 1)[1].splitlines()[0])
    assert list(statuses.values()) == ["error"], report


def _read_until(proc, marker, seconds=120):
    lines, deadline = [], time.monotonic() + seconds
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if marker in line:
            return line
    raise AssertionError("".join(lines))


def test_cli_serves_over_dp_and_stops_on_sigterm(tmp_path):
    port = free_port()
    env = dict(os.environ, **ENV, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE="2", PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    argv = [sys.executable, "-m", "aether_tpu_torch.apps.serve", "--device", "cpu",
            "--random-init", "tiny", "--dp", "2", "--port", "0",
            "--output_dir", str(tmp_path / "out")]
    procs = [subprocess.Popen(argv, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        base = _read_until(procs[0], "serving on http://").split("serving on ", 1)[1].strip()
        status = wait(base, submit(base, (RECON[0], {"video": ("clip.gif", gif_bytes(17))})))
        assert status["status"] == "done", status.get("error")
        assert any(a.endswith("_poses.txt") for a in status["artifacts"])
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
        assert codes == [0, 0], [p.stdout.read() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
