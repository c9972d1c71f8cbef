"""repro_torch's checkpoints and training driver, on the CPU: the
reference's layout (``step_XXXXXXXXX/{arrays.npz, manifest.json, done}``)
with leaves named by path, a round trip of (params, AdamW state) with a
bfloat16 leaf, a torn checkpoint ignored, retention and async writes,
restore onto a device (the default, the card, raises here), a restart that
is bitwise an uninterrupted run, and ``python -m
repro_torch.launch.train``."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint,
)
from repro_torch.configs.base import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import init_adamw, tree_leaves, tree_map

torch.set_num_threads(1)


def _state(seed=0):
    cfg = get_config("smollm-135m").reduced()
    params = tf.init_params(cfg, seed=seed, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].bfloat16()
    opt = init_adamw(params)
    opt["count"] += 7
    return params, opt


def _equal(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_round_trip_keeps_paths_values_and_dtypes(tmp_path):
    params, opt = _state()
    path = save_checkpoint(str(tmp_path), 12, (params, opt),
                           extra={"pipeline": {"step": 12, "seed": 0}})
    assert os.path.basename(path) == "step_000000012"
    assert sorted(os.listdir(path)) == ["arrays.npz", "done",
                                        "manifest.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 12
    leaf = manifest["leaves"]["0/groups/1/l0/mixer/wq"]
    assert leaf["dtype"] == "float32" and leaf["shape"] == list(
        params["groups"][1]["l0"]["mixer"]["wq"].shape)
    assert manifest["leaves"]["0/embed/table"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["1/count"] == {"shape": [], "dtype": "int32"}
    template = tree_map(torch.zeros_like, (params, opt))
    (p2, o2), step, extra = load_checkpoint(str(tmp_path), template,
                                            device="cpu")
    assert step == 12 and extra == {"pipeline": {"step": 12, "seed": 0}}
    assert _equal((p2, o2), (params, opt)) and int(o2["count"]) == 7


def test_torn_checkpoint_is_ignored(tmp_path):
    params, opt = _state()
    save_checkpoint(str(tmp_path), 3, (params, opt))
    torn = save_checkpoint(str(tmp_path), 5, (params, opt))
    os.remove(os.path.join(torn, "done"))          # a crash before the marker
    os.makedirs(tmp_path / "step_000000009.tmp")   # and one mid-write
    assert latest_step(str(tmp_path)) == 3
    _, step, _ = load_checkpoint(str(tmp_path), (params, opt), device="cpu")
    assert step == 3
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "absent"), params, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), {"other": params["final_norm"]},
                        device="cpu")


def test_manager_retention_and_async_snapshots(tmp_path):
    """Async saves snapshot the tensors before returning: an in-place
    update right after ``save`` is not in the checkpoint; only the newest
    ``keep`` checkpoints stay."""
    params, opt = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    kept = []
    for step in (1, 2, 3, 4):
        mgr.save(step, (params, opt), extra={"step": step})
        kept.append(tree_map(torch.clone, (params, opt)))
        for t in tree_leaves(params):
            t.add_(1)                               # the next train step
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000000003",
                                            "step_000000004"]
    for step in (3, 4):
        tree, got, extra = mgr.restore(kept[0], step=step, device="cpu")
        assert got == step and extra == {"step": step}
        assert _equal(tree, kept[step - 1])
    sync = CheckpointManager(str(tmp_path / "sync"), async_save=False)
    sync.save(1, params)
    assert latest_step(str(tmp_path / "sync")) == 1


def test_manager_raises_a_failed_async_write(tmp_path, monkeypatch):
    from repro_torch.checkpoint import io

    def broken(*args):
        raise OSError("disk full")

    params, _ = _state()
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(io, "_write", broken)
    mgr.save(1, params)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # reported once
    assert latest_step(str(tmp_path)) is None


def test_restore_onto_a_device(tmp_path):
    params, opt = _state()
    save_checkpoint(str(tmp_path), 1, params)
    tree, _, _ = load_checkpoint(str(tmp_path), params, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(tree))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_checkpoint(str(tmp_path), params)


ARGS = ["--arch", "smollm-135m", "--reduced", "--batch", "2", "--seq", "8",
        "--device", "cpu", "--log-every", "1"]


def _final(directory, step):
    with np.load(os.path.join(directory, f"step_{step:09d}",
                              "arrays.npz")) as data:
        return {k: data[k].copy() for k in data}


def test_restart_is_bitwise_an_uninterrupted_run(tmp_path, capsys):
    """4 steps in one run against 2 steps, a checkpoint, and a restarted
    run of the remaining 2: the final parameters and AdamW state are
    equal bitwise (the data pipeline regenerates batch i at step i)."""
    train_cli.main(ARGS + ["--steps", "4", "--ckpt-dir",
                           str(tmp_path / "a")])
    train_cli.main(ARGS + ["--steps", "2", "--ckpt-dir",
                           str(tmp_path / "b")])
    train_cli.main(ARGS + ["--steps", "4", "--ckpt-dir",
                           str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    a, b = _final(tmp_path / "a", 4), _final(tmp_path / "b", 4)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    with open(tmp_path / "b" / "step_000000004" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"pipeline": {"step": 4, "seed": 0}}


def test_train_driver_runs_on_cpu_and_defaults_to_the_card(capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--arch", "smollm-135m", "--reduced",
                            "--steps", "1"])
    train_cli.main(ARGS + ["--steps", "3", "--grad-compress"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu  arch: smollm-135m")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 3 and all("loss" in ln and "gnorm" in ln
                                   and "s/step" in ln for ln in steps)
    assert lines[-1] == "done."


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_train_driver_trains_ssm_archs_on_cpu(arch, capsys):
    """The driver trains the rwkv6 and mamba layers (reduced): finite
    losses, one line a step."""
    train_cli.main(["--arch", arch, "--reduced", "--batch", "2", "--seq",
                    "8", "--steps", "2", "--log-every", "1", "--device",
                    "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"device: cpu  arch: {arch}")
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert lines[-1] == "done."
