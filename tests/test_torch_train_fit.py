"""The port's training loop and commands on the CPU: ``Trainer.fit``
for two epochs on a tiny on-disk set (finite losses, the JAX package's
validation metric keys, checkpoint and resume with the optimizer state
equal), pretrained weights from a checkpoint, and the train -> export
-> finetune -> infer3d chain of commands; the unported flags are
refused by name."""

import copy
import os

import pytest

pytest.importorskip("yaml", reason="the recipes and descriptors are yaml")

import numpy as np
import torch

from empanada_torch.data.image_files import write_png
from empanada_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads for this module: the suite runs six pytest
    workers on the machine's cores, and torch's default (one thread a
    core in every worker) makes their spinning threads starve each
    other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)

TINY = dict(arch="PanopticBiFPNPR", encoder="regnety_200mf", num_classes=1,
            fpn_dim=64, fpn_layers=1, train_num_points=64,
            subdivision_num_points=256)


def _config(**train):
    tcfg = {"batch_size": 2, "schedule_params": {"max_lr": 3e-3,
                                                 "epochs": 1},
            "optimizer": "AdamW", "optimizer_params": {"weight_decay": 0.1}}
    tcfg.update(train)
    return {"DATASET": {"labels": [1], "thing_list": [1],
                        "class_names": {1: "mito"},
                        "norms": {"mean": 0.5, "std": 0.15}},
            "MODEL": dict(TINY), "TRAIN": tcfg}


def _write_set(root, counts, size=144, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for si, n in enumerate(counts):
        for sub in ("images", "masks"):
            os.makedirs(os.path.join(root, f"src{si}", sub), exist_ok=True)
        for i in range(n):
            img = rng.normal(110, 20, (size, size))
            msk = np.zeros((size, size), np.uint16)
            for k in range(1, 5):
                cy, cx = rng.uniform(0, size, 2)
                r = rng.uniform(8, 20)
                inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                msk[inside] = k
                img[inside] = 200
            write_png(os.path.join(root, f"src{si}", "images", f"{i}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            write_png(os.path.join(root, f"src{si}", "masks", f"{i}.png"),
                      msk)


def _fit_config(tmp_path):
    _write_set(str(tmp_path / "train"), [4, 2])
    _write_set(str(tmp_path / "eval"), [2], seed=1)
    cfg = _config(
        run_name="tiny", train_dir=str(tmp_path / "train"),
        model_dir=str(tmp_path / "models"), workers=1, print_freq=1,
        logging=False, dataset_params={"weight_gamma": 0.7},
        schedule_params={"max_lr": 3e-3, "epochs": 2},
        augmentations=[{"aug": "PadIfNeeded", "min_height": 128,
                        "min_width": 128},
                       {"aug": "RandomCrop", "height": 128, "width": 128},
                       {"aug": "Rotate", "limit": 180},
                       {"aug": "HorizontalFlip"}])
    cfg["EVAL"] = {
        "eval_dir": str(tmp_path / "eval"), "epochs_per_eval": 1,
        "engine": "PanopticDeepLabEngine",
        "engine_params": {"thing_list": [1], "label_divisor": 1000},
        "metrics": [
            {"metric": "IoU", "name": "semantic_iou", "labels": [1],
             "output_key": "sem_logits", "target_key": "sem"},
            {"metric": "PQ", "name": "pq", "labels": [1],
             "label_divisor": 1000},
            {"metric": "F1", "name": "f1_50", "labels": [1],
             "label_divisor": 1000, "iou_thr": 0.5}]}
    return cfg


def test_fit_validates_checkpoints_and_resumes(tmp_path):
    cfg = _fit_config(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    history = trainer.fit()
    assert len(history) == 2 and len(trainer.timeline) == 6
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert set(history[0]) == {"ce", "l1", "mse", "pointrend_ce",
                               "total_loss", "sem_iou"}
    metrics = trainer.validate()
    # the JAX package's key set: <class name>_<metric name>
    assert set(metrics) == {"mito_semantic_iou", "mito_pq", "mito_f1_50"}
    ckpt = trainer.checkpoint_path()
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".json")

    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg["TRAIN"]["resume"] = ckpt
    resumed = Trainer(resumed_cfg, device="cpu")
    resumed.init_state(3)
    assert resumed.start_epoch == 2 and resumed.step == 6
    for p, q in zip(trainer.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(trainer.optimizer.state[p][key],
                               resumed.optimizer.state[q][key])
    assert resumed.scheduler.last_epoch == trainer.scheduler.last_epoch
    history = resumed.fit(epochs=3)
    assert len(history) == 1 and resumed.step == 9


def test_commands_train_export_finetune_infer(tmp_path):
    """train -> export -> finetune -> the re-exported descriptor runs
    infer3d's stack path, all on the CPU."""
    import yaml

    from empanada_torch.cli import export, finetune, train
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.export import load_exported_model

    cfg = _fit_config(tmp_path)
    cfg["EVAL"]["epochs_per_eval"] = 0
    cfg["TRAIN"]["schedule_params"]["epochs"] = 1
    with open(tmp_path / "train.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    train.main([str(tmp_path / "train.yaml"), "--device", "cpu"])
    ckpt = tmp_path / "models" / "tiny_checkpoint.pth"
    export.main([str(tmp_path / "train.yaml"), str(ckpt),
                 str(tmp_path / "export"), "-name", "tiny"])
    desc_path = tmp_path / "export" / "tiny.yaml"
    model, desc = load_exported_model(str(desc_path), device="cpu")
    state = torch.load(ckpt, weights_only=True)["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k

    ft = {"MODEL": {"config": str(desc_path)},
          "TRAIN": {"run_name": "ft", "train_dir": str(tmp_path / "train"),
                    "model_dir": str(tmp_path / "ft"),
                    "finetune_layer": "stage4", "batch_size": 2,
                    "workers": 1, "logging": False, "print_freq": 1,
                    "schedule_params": {"max_lr": 3e-4, "epochs": 1},
                    "optimizer": "AdamW",
                    "optimizer_params": {"weight_decay": 0.1},
                    "augmentations": [{"aug": "RandomCrop", "height": 128,
                                       "width": 128}]}}
    with open(tmp_path / "ft.yaml", "w") as f:
        yaml.safe_dump(ft, f)
    finetune.main([str(tmp_path / "ft.yaml"), "--device", "cpu"])
    tuned, _ = load_exported_model(str(tmp_path / "ft" / "ft_finetuned.yaml"),
                                   device="cpu")
    before, after = model.state_dict(), tuned.state_dict()
    for k in before:
        if k.startswith(("encoder_mod.stem.", "encoder_mod.stage1",
                         "encoder_mod.stage2", "encoder_mod.stage3")) \
                and not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked")):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["semantic_head.Conv_0.weight"],
                           after["semantic_head.Conv_0.weight"])
    assert not torch.equal(
        before["encoder_mod.stage1_block1.ConvBNAct_0.BatchNorm_0.running_var"],
        after["encoder_mod.stage1_block1.ConvBNAct_0.BatchNorm_0.running_var"])

    vol = np.random.default_rng(0).integers(0, 255, (4, 64, 64),
                                            dtype=np.uint8)
    out = run_inference3d(tuned, vol, labels=[1], thing_list=[1],
                          mode="stack", device="cpu", progress=False,
                          norms=desc["norms"])
    assert sorted(out) == [1] and out[1].shape3d == vol.shape


@pytest.mark.parametrize("argv, flag", [
    (["c.yaml", "--coordinator", "h:1"], "--coordinator"),
    (["c.yaml", "--num-processes", "2"], "--num-processes"),
    (["c.yaml", "--process-id", "0"], "--process-id")])
def test_train_refuses_multiprocess_flags(argv, flag):
    """The multi-process flags keep the JAX command's meaning (hosts):
    ``--coordinator`` is the rendezvous of every worker; one host with
    ``--process-id 0`` starts a worker per card with a local rendezvous;
    ``--num-processes`` > 1 without a coordinator is refused, as
    ``jax.distributed.initialize`` refuses it."""
    from empanada_torch.cli import train

    args = train.parse_args(argv)
    if flag == "--num-processes":
        with pytest.raises(SystemExit, match="needs --coordinator"):
            train.plan_workers(args, n_cards=2)
        return
    plan = train.plan_workers(args, n_cards=4)
    assert plan["world"] == 4 and plan["ranks"] == [0, 1, 2, 3]
    assert plan["backend"] == "nccl" and plan["device"] is None
    if flag == "--coordinator":
        assert plan["coordinator"] == "h:1"
    else:
        assert plan["coordinator"].startswith("127.0.0.1:")
    hosts = train.plan_workers(train.parse_args(
        argv + ["--num-processes", "3", "--process-id", "2",
                "--coordinator", "h:2"]), n_cards=4)
    assert hosts["world"] == 12 and hosts["ranks"] == [8, 9, 10, 11]


def test_whole_pretraining_loads_a_checkpoint(tmp_path):
    first = Trainer(_config(), device="cpu", seed=5)
    first.init_state(4)
    first.save(str(tmp_path / "a.pth"), 1)
    second = Trainer(_config(whole_pretraining=str(tmp_path / "a.pth")),
                     device="cpu", seed=6)
    second.init_state(4)
    for p, q in zip(first.model.parameters(), second.model.parameters()):
        assert torch.equal(p, q)
    assert second.start_epoch == 0


def test_export_quantize_writes_the_int8_artifact(tmp_path, capsys):
    """``export --quantize`` on a training checkpoint writes the float32
    and the weight-only int8 artifacts; the int8 one loads dequantized."""
    import yaml

    from empanada_torch.cli import export
    from empanada_torch.export import (
        dequantize_state_int8,
        load_exported_model,
        quantize_state_int8,
    )

    trainer = Trainer(_config(), device="cpu", seed=2)
    trainer.init_state(4)
    trainer.save(str(tmp_path / "ckpt.pth"), 1)
    with open(tmp_path / "recipe.yaml", "w") as f:
        yaml.safe_dump(_config(), f)
    export.main([str(tmp_path / "recipe.yaml"), str(tmp_path / "ckpt.pth"),
                 str(tmp_path / "out"), "-name", "q", "--quantize"])
    assert "model_quantized" in capsys.readouterr().out
    with open(tmp_path / "out" / "q.yaml") as f:
        desc = yaml.safe_load(f)
    assert desc["model_quantized"] == str(tmp_path / "out" / "q.int8.pth")
    assert "act_scales" not in desc
    model, _ = load_exported_model(str(tmp_path / "out" / "q.yaml"),
                                   quantized=True, device="cpu")
    want = dequantize_state_int8(quantize_state_int8(
        trainer.model.state_dict()))
    for key, value in model.state_dict().items():
        assert torch.equal(value, want[key]), key
