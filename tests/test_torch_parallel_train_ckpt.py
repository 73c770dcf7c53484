"""Checkpoints of the port's mesh ``Trainer`` across topologies, and the
trainer CLI's mesh flags (counterparts of ``tests/test_fsdp.py:112-150`` and
of the JAX CLI's guards, ``aether_tpu/train/trainer.py:402-432``).

A run at (dp = 2, tp = 2) with FSDP saves the one-card format at step 2 on
rank 0. It restores bit for bit (parameters, EMA, both AdamW moments,
counters, generator, step) in one process without a mesh, at (dp = 4,
tp = 1) with FSDP and at (dp = 2, pp = 2), and each continues for two
steps: the three continuations agree at ``test_fsdp.py``'s tolerances
(losses rtol 2e-4 / atol 2e-5, parameters rtol 5e-4 / atol 5e-5). The
one-process continuation's own checkpoint restores bit for bit at (2, 2)
with FSDP, and one saved mid-accumulation (``grad_accum_steps=2``, a
gradient pending) restores bit for bit in one process and at (4, 1). The
CLI runs ``--dp 2``, ``--dp 2 --fsdp`` and ``--pp 2`` on two gloo ranks
through ``launch.run_main`` (rank 0 alone prints, the loss of the same run
in one process), and refuses ``--pp`` with ``--tp`` and ``--fsdp`` without
dp > 1 with the JAX messages. Rank 0 alone decides whether to resume and
whether to save, so ranks whose file systems differ still agree.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from aether_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = {"OMP_NUM_THREADS": "1"}
BATCH = 4


def _train(ckpt, accum=1):
    return dict(learning_rate=1e-3, warmup_steps=1, total_steps=4, grad_clip_norm=1.0,
                grad_accum_steps=accum, remat=False, log_every=100, checkpoint_dir=ckpt,
                checkpoint_every=100)


def _case(name, mesh, fsdp, ckpt, steps, skip=0, accum=1):
    return dict(name=name, mesh=mesh, fsdp=fsdp, train=_train(ckpt, accum), batch=BATCH,
                data_seed=3, steps=steps, skip=skip, restored_state=skip > 0)


def _equal(a, b, path=""):
    """Bit-equality of two checkpoint trees (tensors, dicts, lists, scalars)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a.cpu(), b.cpu()), path
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    else:
        assert a == b, (path, a, b)


def _one_process(ckpt, steps, accum=1):
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.train.trainer import TrainConfig, Trainer, synthetic_batches

    trainer = Trainer(DiTConfig.tiny(), TrainConfig(**_train(ckpt, accum)), device="cpu",
                      seed=99)
    restored = trainer.gathered_state()
    batches = synthetic_batches(DiTConfig.tiny(), batch_size=BATCH, seed=3)
    for _ in range(trainer.state.step):
        next(batches)
    losses = trainer.fit(batches, steps=steps)
    return trainer, restored, losses


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {k: str(root / k) for k in ("a", "b", "c", "d", "e", "f")}
    saved_run = spawn("torch_train_ranks:rank_trainers", 4, dict(cases=[
        _case("save", ("tp", 2, 2), True, dirs["a"], 2),
        # three calls at accumulation 2: saved with one gradient pending
        _case("save_accum", ("tp", 2, 2), True, dirs["e"], 3, accum=2),
    ]), extra_path=[HERE], env=ENV)
    assert sorted(os.listdir(dirs["a"])) == ["step_00000002"]
    os.makedirs(dirs["f"])
    shutil.copy(os.path.join(dirs["e"], "step_00000003"), dirs["f"])
    saved_accum = torch.load(os.path.join(dirs["e"], "step_00000003"), weights_only=True)
    _, one_accum, _ = _one_process(dirs["e"], 0, accum=2)
    for k in ("b", "c"):
        os.makedirs(dirs[k])
        shutil.copy(os.path.join(dirs["a"], "step_00000002"), dirs[k])
    saved = torch.load(os.path.join(dirs["a"], "step_00000002"), weights_only=True)
    one, one_restored, one_losses = _one_process(dirs["a"], 2)
    os.makedirs(dirs["d"])
    shutil.copy(os.path.join(dirs["a"], "step_00000004"), dirs["d"])
    one_saved = torch.load(os.path.join(dirs["d"], "step_00000004"), weights_only=True)
    restored = spawn("torch_train_ranks:rank_trainers", 4, dict(cases=[
        _case("fsdp41", ("tp", 4, 1), True, dirs["b"], 2, skip=2),
        _case("pp22", ("pp", 2, 2), False, dirs["c"], 2, skip=2),
        dict(_case("from_one", ("tp", 2, 2), True, dirs["d"], 0, skip=4), state=False),
        dict(_case("accum41", ("tp", 4, 1), True, dirs["f"], 0, skip=3, accum=2), state=False),
    ]), extra_path=[HERE], env=ENV)
    return dict(saved_run=saved_run, saved=saved, one=one, one_restored=one_restored,
                one_losses=one_losses, one_saved=one_saved, restored=restored,
                saved_accum=saved_accum, one_accum=one_accum)


def test_mesh_checkpoint_is_the_one_card_format(ckpt_runs):
    saved, run = ckpt_runs["saved"], ckpt_runs["saved_run"]
    assert saved["step"] == 2 and saved["optimizer"]["count"] == 2
    _equal(run[0]["save"]["state"], saved)  # rank 0 wrote what it gathered
    assert all(not r["save"]["main"] for r in run[1:])
    from aether_tpu_torch.config import DiTConfig
    from aether_tpu_torch.models.dit import DiT

    with torch.device("meta"):
        names = [n for n, _ in DiT(DiTConfig.tiny()).named_parameters()]
    assert list(saved["params"]) == names == list(saved["ema_params"])
    assert sorted(saved["optimizer"]["adamw"]["state"]) == list(range(len(names)))


@pytest.mark.parametrize("name", ["one_process", "fsdp41", "pp22"])
def test_checkpoint_restores_bit_equal_at_another_topology(ckpt_runs, name):
    saved = ckpt_runs["saved"]
    if name == "one_process":
        got = ckpt_runs["one_restored"]
    else:
        runs = ckpt_runs["restored"]
        assert all(r[name]["restored_step"] == 2 for r in runs)
        got = runs[0][name]["restored"]
    _equal(got, saved)


@pytest.mark.parametrize("name", ["fsdp41", "pp22"])
def test_restored_runs_keep_training_alike(ckpt_runs, name):
    ref_losses = ckpt_runs["one_losses"]
    ref = ckpt_runs["one_saved"]
    res = ckpt_runs["restored"][0][name]
    assert res["step"] == 4 and np.isfinite(res["losses"]).all()
    np.testing.assert_allclose(res["losses"], ref_losses, rtol=2e-4, atol=2e-5)
    for key in ("params", "ema_params"):
        for n, want in ref[key].items():
            np.testing.assert_allclose(res["state"][key][n].numpy(), want.numpy(),
                                       rtol=5e-4, atol=5e-5, err_msg=f"{key} {n}")
    moved = max(float((ref["params"][n] - ckpt_runs["saved"]["params"][n]).abs().max())
                for n in ref["params"])
    assert moved > 1e-4  # the continuation trained


@pytest.mark.parametrize("name", ["one_process", "accum41"])
def test_checkpoint_mid_accumulation_restores_bit_equal(ckpt_runs, name):
    saved = ckpt_runs["saved_accum"]
    opt = saved["optimizer"]
    assert (opt["count"], opt["mini_step"]) == (1, 1) and len(opt["acc"]) == len(saved["params"])
    if name == "one_process":
        got = ckpt_runs["one_accum"]
    else:
        assert all(r[name]["restored_step"] == 3 for r in ckpt_runs["restored"])
        got = ckpt_runs["restored"][0][name]["restored"]
    _equal(got, saved)


def test_one_card_checkpoint_restores_bit_equal_on_a_mesh(ckpt_runs):
    runs = ckpt_runs["restored"]
    assert all(r["from_one"]["restored_step"] == 4 for r in runs)
    _equal(runs[0]["from_one"]["restored"], ckpt_runs["one_saved"])


def rank_local_disks(root):
    """Two ranks at dp = 2, each checkpointing into a directory of its own,
    as ranks on local disks do; rank 1's holds a stale, unreadable
    ``step_00000002``. Two steps, saved at step 2."""
    import torch.distributed as dist

    from aether_tpu_torch.parallel import initialize
    from torch_train_ranks import rank_trainers

    initialize(device="cpu")
    ckpt = os.path.join(root, f"rank{dist.get_rank()}")
    case = dict(_case("local", ("tp", 2, 1), False, ckpt, 2), batch=2, state=False)
    case["train"]["checkpoint_every"] = 2
    return rank_trainers([case])["local"]


def test_checkpoint_decisions_follow_rank_0(tmp_path):
    """Whether to resume and whether to save are rank 0's decisions: a stale
    step only rank 1 sees neither resumes rank 1 alone nor keeps it out of
    the save's gather (which would hang the other ranks)."""
    stale = tmp_path / "rank1" / "step_00000002"
    stale.parent.mkdir()
    stale.write_bytes(b"stale")
    runs = spawn(f"{__name__}:rank_local_disks", 2, dict(root=str(tmp_path)), timeout=120,
                 extra_path=[HERE], env=ENV)
    assert [r["restored_step"] for r in runs] == [0, 0]
    assert [r["step"] for r in runs] == [2, 2] and runs[0]["losses"] == runs[1]["losses"]
    assert stale.read_bytes() == b"stale"
    saved = torch.load(tmp_path / "rank0" / "step_00000002", weights_only=True)
    assert saved["step"] == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = {"dp2": ["--dp", "2"], "dp2_fsdp": ["--dp", "2", "--fsdp"], "pp2": ["--pp", "2"]}
ARGS = ["--synthetic", "--tiny", "--device", "cpu", "--steps", "2", "--batch_size", "2"]


def rank_cli():
    from aether_tpu_torch.parallel.launch import run_main

    torch.set_num_threads(1)
    return {name: run_main("aether_tpu_torch.train.trainer", ARGS + extra)
            for name, extra in CLI.items()}


@pytest.fixture(scope="module")
def cli_runs():
    return spawn(f"{__name__}:rank_cli", 2, {}, extra_path=[HERE], env=ENV)


@pytest.mark.parametrize("name", list(CLI))
def test_cli_mesh_run_matches_one_process(cli_runs, name, capsys):
    from aether_tpu_torch.train.trainer import main

    main(ARGS)
    one = re.findall(r"step 2: loss=([0-9.]+)", capsys.readouterr().out)
    rank0, rank1 = (r[name] for r in cli_runs)
    assert rank1 == ""  # only rank 0 prints
    assert "mesh: DeviceMesh" in rank0
    got = re.findall(r"step 2: loss=([0-9.]+)", rank0)
    assert got == one and len(one) == 1, (rank0, one)


def test_cli_guards():
    from aether_tpu_torch.train.trainer import main

    with pytest.raises(SystemExit, match="--pp and --tp are mutually exclusive"):
        main(ARGS + ["--pp", "2", "--tp", "2"])
    with pytest.raises(SystemExit, match=r"--fsdp needs a \(dp>1, tp\) mesh \(not --pp\)"):
        main(ARGS + ["--fsdp"])
    with pytest.raises(SystemExit, match=r"--fsdp needs a \(dp>1, tp\) mesh"):
        main(ARGS + ["--fsdp", "--dp", "2"])  # one process: no mesh
    with pytest.raises(ValueError, match=r"dp\(1\) \* pp\(2\) != num devices \(1\)"):
        main(ARGS + ["--pp", "2"])
