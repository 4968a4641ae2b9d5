"""Config-driven trainer: training and finetuning (the MitoNet recipe,
the Panoptic-DeepLab and boundary-contour recipes) on one device, or
data-parallel over the ranks of a ``torch.distributed`` process group.

The JAX package's ``Trainer`` in PyTorch, with the same recipe keys:

- the model starts from the JAX package's init (``init_train_``), a
  port checkpoint or an exported descriptor (``whole_pretraining``);
- one step: forward in train mode (batch statistics, PointRend points
  from the trainer's ``torch.Generator``), the recipe's loss, backward,
  clipping by global norm, the optimizer, the LR schedule; on CUDA with
  ``MODEL.dtype: bfloat16`` the forward and the loss run under
  ``torch.autocast`` in bfloat16 over float32 weights (no grad scaler),
  elsewhere in float32;
- ``TRAIN.finetune_layer`` freezes the encoder stages below it: frozen
  parameters stay out of the optimizer (no update, no decay) while the
  whole model stays in train mode, so their batch-norm statistics move
  (as ``optax.set_to_zero`` under a train-mode apply does);
- validation runs the 2D engine over EVAL.eval_dir (padded to a
  multiple of 128) and postprocesses predictions and GT targets to
  panoptic maps, both through the pixel-grouping kernel on the card;
  with a boundary-contour engine (``BCEngine``) it scores the semantic
  channel only;
- checkpoints hold model, optimizer, schedule, step and epoch.

``TRAIN.encoder_pretraining`` loads a CEM torch encoder checkpoint
(``train.torch_weights``) and takes its norms when it carries them.

Data parallelism (a process group of world size N > 1 is up, one rank
per card, see ``parallel.initialize_distributed``) keeps the JAX
package's mesh semantics, so a step at world N equals one process's step
on the same global batch:

- ``TRAIN.batch_size`` is the GLOBAL batch; each rank loads rows
  [r*b, (r+1)*b) of every global batch, b = batch_size / N, so the
  ranks of one host load one process's batches index for index; across
  hosts (``LOCAL_WORLD_SIZE`` < N) with dataset weights, each host draws
  its own batch through ``DistributedWeightedSampler``, as the JAX
  package's processes do, and its ranks take rows of it;
- each rank augments from its own streams (child r of the seed's
  ``SeedSequence``), so no two ranks repeat a draw;
- the model runs under ``DistributedDataParallel`` with batch norm over
  the global batch (``set_sync_batchnorm``), the loss over the global
  batch (``losses.GlobalBatch``) and the PointRend points drawn for the
  global batch (``GlobalDraw``);
- validation, checkpoints and the logger run on rank 0 while the others
  wait at a barrier.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from empanada_torch import losses as losses_mod
from empanada_torch import metrics as metrics_mod
from empanada_torch.data import DataLoader, create_dataset
from empanada_torch.data.utils.sampler import (
    DistributedWeightedSampler,
    WeightedRandomSampler,
)
from empanada_torch.data.utils.transforms import create_augmentations
from empanada_torch.device import resolve_device
from empanada_torch.models import create_model
from empanada_torch.models.blocks import set_sync_batchnorm
from empanada_torch.models.point_rend import GlobalDraw
from empanada_torch.parallel.mesh import world
from empanada_torch.train.checkpoint import restore_state, save_checkpoint
from empanada_torch.train.optim import (
    clip_by_global_norm_,
    configure_optimizer,
    create_lr_schedule,
)

__all__ = ["Trainer", "finetune_trainable_mask", "load_pretrained_state"]

def finetune_trainable_mask(named_params, finetune_layer="all",
                            encoder_key="encoder_mod"):
    """{name: True = trainable}: the encoder's stages below
    ``finetune_layer`` freeze ("none" freezes the whole encoder); resnet
    ('layerN') and regnet ('stageN') stage names both count."""
    valid_layers = ["stage1", "stage2", "stage3", "stage4"]
    if finetune_layer not in ("all", "none"):
        assert finetune_layer in valid_layers, finetune_layer
        start = valid_layers.index(finetune_layer)
        unfrozen = set()
        for name in valid_layers[start:]:
            unfrozen.update((name, name.replace("stage", "layer")))

    def trainable(parts):
        if encoder_key not in parts or finetune_layer == "all":
            return True
        if finetune_layer == "none":
            return False
        return any(p.startswith(u) for u in unfrozen for p in parts)

    return {name: trainable(name.split(".")) for name, _ in named_params}


def load_pretrained_state(path):
    """A port checkpoint, an exported descriptor (.yaml) or a bare state
    dict -> state dict on the CPU."""
    if path.endswith((".yaml", ".yml")):
        from empanada_torch.config import read_yaml

        desc = read_yaml(path)
        weights = desc["model"]
        if not os.path.isabs(weights):
            weights = os.path.join(os.path.dirname(path),
                                   os.path.basename(weights))
        path = weights
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["model"] if "model" in state and "optimizer" in state \
        else state


class Trainer:
    """Builds everything from a recipe dict and runs the epoch loop.
    ``device``: this process's card unless named (raises without a card
    when none is named). ``seed`` seeds the init, the loader's order and
    augmentations, and the PointRend points. Data-parallel when a process
    group of more than one rank is up (see the module's docstring)."""

    def __init__(self, config, device=None, seed=0):
        self.config = config
        self.device = resolve_device(device)
        self.seed = seed
        self.world, self.rank = world()

        mcfg = dict(config["MODEL"])
        self.arch = mcfg.pop("arch")
        # the model keeps float32 compute; MODEL.dtype bfloat16 trains
        # under autocast on the card
        self.amp_dtype = torch.bfloat16 if (
            mcfg.pop("dtype", None) in ("bfloat16", "bf16")
            and self.device.type == "cuda") else None
        self.model = create_model(self.arch, device="cpu", seed=seed,
                                  init="train", **mcfg).to(self.device)

        tcfg = config["TRAIN"]
        self.criterion = losses_mod.create_loss(
            tcfg.get("criterion", "PanopticLoss"),
            **tcfg.get("criterion_params", {}))
        self.norms = config["DATASET"].get("norms", {"mean": 0.5, "std": 0.29})
        self.batch_size = tcfg.get("batch_size", 8)
        if self.batch_size % self.world:
            raise ValueError(f"TRAIN.batch_size {self.batch_size} does not "
                             f"divide over {self.world} ranks")
        self.finetune_layer = tcfg.get("finetune_layer", "all")
        self.points = torch.Generator(self.device).manual_seed(seed + 1)
        self.ddp = None
        if self.world > 1:
            self.points = GlobalDraw(self.points, self.world, self.rank)
            set_sync_batchnorm(self.model, self.world)
            self.criterion.global_batch = losses_mod.GlobalBatch()
        self.optimizer = None
        self.start_epoch = 0
        self.step = 0
        self.timeline = []  # one dict per train step of fit()

    # --- data -------------------------------------------------------

    def _dataset_params(self, dcfg, tcfg):
        name = tcfg.get("dataset_class", "SingleClassInstanceDataset")
        params = dict(tcfg.get("dataset_params", {}))
        if name == "PanopticDataset":
            params.setdefault("labels", dcfg["labels"])
            params.setdefault("thing_list", dcfg["thing_list"])
            params.setdefault("label_divisor",
                              tcfg.get("label_divisor", 1000))
        return name, params

    def build_loader(self):
        tcfg = self.config["TRAIN"]
        # each rank augments from streams of its own: child `rank` of the
        # seed's sequence (one process keeps the sequence itself)
        augs = create_augmentations(
            tcfg.get("augmentations", []), norms=self.norms, seed=self.seed,
            spawn_key=(self.rank,) if self.world > 1 else ())
        name, params = self._dataset_params(self.config["DATASET"], tcfg)
        dataset = create_dataset(name, tcfg["train_dir"], transforms=augs,
                                 **params)
        for extra_dir in tcfg.get("additional_train_dirs") or []:
            dataset = dataset + create_dataset(
                name, extra_dir, transforms=augs, **params)
        # LOCAL_WORLD_SIZE: the ranks a host, as torch's launchers and the
        # train command set it (one host by default)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", self.world)) \
            if self.world > 1 else 1
        if self.world % local:
            raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the "
                             f"world of {self.world} ranks")
        hosts = self.world // local
        sampler = None
        batch, replicas = self.batch_size, (self.world, self.rank)
        if dataset.weights is not None and hosts > 1:
            # across hosts, as the JAX package's processes: each host draws
            # its own batch, its ranks take rows of it
            sampler = DistributedWeightedSampler(
                len(dataset), dataset.weights, num_replicas=hosts,
                rank=self.rank // local, seed=self.seed)
            batch, replicas = self.batch_size // hosts, \
                (local, self.rank % local)
        elif dataset.weights is not None:
            sampler = WeightedRandomSampler(dataset.weights, seed=self.seed)
        return DataLoader(
            dataset, batch_size=batch, sampler=sampler,
            shuffle=sampler is None, drop_last=True,
            num_workers=tcfg.get("workers", 4), seed=self.seed,
            pin_memory=self.device.type == "cuda", num_replicas=replicas[0],
            rank=replicas[1])

    # --- state ------------------------------------------------------

    def init_state(self, steps_per_epoch):
        """Pretrained weights, the optimizer over the trainable
        parameters, the LR schedule, and the resume."""
        tcfg = self.config["TRAIN"]
        if tcfg.get("whole_pretraining"):
            self.model.load_state_dict(
                load_pretrained_state(tcfg["whole_pretraining"]))
            print(f"=> loaded whole pretraining {tcfg['whole_pretraining']}")
        elif tcfg.get("encoder_pretraining"):
            from empanada_torch.train.torch_weights import (
                load_encoder_pretraining,
            )

            norms = load_encoder_pretraining(self.model,
                                             tcfg["encoder_pretraining"])
            if norms:
                self.norms = norms

        named = list(self.model.named_parameters())
        mask = finetune_trainable_mask(named, self.finetune_layer)
        for name, p in named:
            p.requires_grad_(mask[name])
        self.trainable = [(n, p) for n, p in named if mask[n]]

        self.lr_schedule = create_lr_schedule(
            tcfg.get("lr_schedule", "OneCycleLR"), steps_per_epoch,
            **tcfg.get("schedule_params", {"max_lr": 3e-3, "epochs": 1}))
        opt_params = tcfg.get("optimizer_params", {})
        self.grad_clip = opt_params.get("grad_clip")
        self.optimizer = configure_optimizer(
            self.trainable, tcfg.get("optimizer", "AdamW"), **opt_params)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, self.lr_schedule)

        self.start_epoch = 0
        self.step = 0
        if tcfg.get("resume"):
            self.step, meta = restore_state(tcfg["resume"], self.model,
                                            self.optimizer, self.scheduler)
            self.start_epoch = int(meta.get("epoch", 0))
            self.resume_run_id = meta.get("run_id")
            print(f"=> resumed from {tcfg['resume']} at epoch "
                  f"{self.start_epoch}")
        if self.world > 1:
            # after the freeze: DDP reduces the trainable parameters only
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.model, broadcast_buffers=False,
                device_ids=[self.device.index]
                if self.device.type == "cuda" else None)

    # --- steps ------------------------------------------------------

    def autocast(self):
        if self.amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, self.amp_dtype)

    def to_device(self, batch):
        """A collated batch (NHWC numpy layout) -> NCHW float32 tensors
        on the device: image (N, 1, H, W), sem (N, H, W), and those of
        ctr_hmp (N, 1, H, W), offsets (N, 2, H, W) and the contour cnt
        (N, H, W) that the dataset gives."""
        out = {}
        for key in ("image", "sem", "ctr_hmp", "offsets", "cnt"):
            if key not in batch:
                continue
            t = torch.as_tensor(batch[key]).to(self.device,
                                               non_blocking=True)
            if t.ndim == 4:
                t = t.permute(0, 3, 1, 2)
            out[key] = t.float().contiguous()
        return out

    def train_step(self, batch, point_coords=None):
        """One optimizer step on a collated batch (this rank's rows of
        the global batch); returns the loss parts and the global batch's
        semantic IoU as device tensors (no host sync). ``point_coords``
        (N, P, 2), this rank's rows, replaces the PointRend draw."""
        self.model.train()
        b = self.to_device(batch)
        with self.autocast():
            out = (self.ddp or self.model)(
                b["image"], point_coords=point_coords, generator=self.points)
            total, aux = self.criterion(out, b)
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if self.grad_clip:
            clip_by_global_norm_([p for _, p in self.trainable],
                                 self.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        with torch.no_grad():
            logits = out["sem_logits"].float()
            pred = logits.argmax(1) > 0 if logits.shape[1] > 1 \
                else logits[:, 0] > 0
            tgt = b["sem"] > 0
            counts = torch.stack([(pred & tgt).sum(), pred.sum(), tgt.sum()])
            gb = self.criterion.global_batch
            if gb is not None:
                counts = gb.sum(counts)
            inter, n_pred, n_tgt = counts
            union = n_pred + n_tgt - inter
            aux["sem_iou"] = (inter + 1e-5) / (union + 1e-5)
        return {k: v.detach() for k, v in aux.items()}

    # --- validation -------------------------------------------------

    def eval_dataset(self):
        tcfg = self.config["TRAIN"]
        augs = create_augmentations([{"aug": "FactorPad", "factor": 128}],
                                    norms=self.norms)
        name, params = self._dataset_params(self.config["DATASET"], tcfg)
        params.pop("weight_gamma", None)
        return create_dataset(name, self.config["EVAL"]["eval_dir"],
                              transforms=augs, weight_gamma=None, **params)

    def validate(self, logger=None, epoch=None):
        """Panoptic validation on EVAL.eval_dir: the configured engine on
        each eval image, prediction and GT targets postprocessed to
        panoptic maps, scored by EVAL.metrics. Returns
        {"<class>_<metric>": value}."""
        from empanada_torch.inference.engines import EvalModel, create_engine
        from empanada_torch.ops.postprocess import get_panoptic_segmentation

        ecfg = self.config.get("EVAL") or {}
        if not ecfg.get("eval_dir"):
            return {}
        dcfg = self.config["DATASET"]
        dataset = self.eval_dataset()
        engine_params = dict(ecfg.get("engine_params", {}))
        engine_params.setdefault("thing_list", dcfg["thing_list"])
        engine = create_engine(
            ecfg.get("engine", "PanopticDeepLabEngine"),
            EvalModel(self.model, self.amp_dtype), device=self.device,
            **engine_params)
        meters = _build_meters(ecfg.get("metrics", []),
                               dcfg.get("class_names", {}))
        thing_list = engine_params["thing_list"]
        track = set(ecfg.get("eval_track_indices") or [])
        snapshot = (logger is not None and track and epoch is not None
                    and (epoch + 1) % max(ecfg.get("eval_track_freq", 1),
                                          1) == 0)
        n_classes = int(self.config["MODEL"].get("num_classes", 1))

        is_bc = not hasattr(engine, "postprocess")  # the BC engines
        for i in range(len(dataset)):
            ex = dataset[i]
            image = torch.from_numpy(ex["image"]).permute(2, 0, 1)[None]
            out = engine.infer(image)
            tgt_sem = torch.from_numpy(
                np.asarray(ex["sem"], np.float32)).to(self.device)
            if is_bc:
                # the BC engines give sigmoid maps and no centers: score
                # the semantic channel only (logit sign = prob > 0.5)
                meters.evaluate({"sem_logits": out["bc"][:, :1] - 0.5},
                                {"sem": tgt_sem[None]})
                continue
            if hasattr(engine, "get_instance_cells"):
                cells = engine.get_instance_cells(out["ctr_hmp"],
                                                  out["offsets"])
                pred_pan = engine.get_panoptic_seg(out["sem"], cells)
            else:
                pred_pan = engine.postprocess(out["sem"], out["ctr_hmp"],
                                              out["offsets"])
            pred_pan = pred_pan.cpu().numpy()
            if snapshot and i in track:
                _save_eval_snapshot(logger, epoch, i, ex["image"], pred_pan)
            if n_classes > 1:
                tgt_prob = torch.stack([(tgt_sem == c).float()
                                        for c in range(n_classes)])
            else:
                tgt_prob = tgt_sem[None]
            tgt_pan = get_panoptic_segmentation(
                tgt_prob[None],
                torch.from_numpy(ex["ctr_hmp"][..., 0])[None].to(self.device),
                torch.from_numpy(ex["offsets"])[None].to(self.device),
                thing_list,
                label_divisor=engine_params.get("label_divisor", 1000),
                stuff_area=engine_params.get("stuff_area", 64),
                void_label=engine_params.get("void_label", 0),
                threshold=engine_params.get("nms_threshold", 0.1),
                nms_kernel=engine_params.get("nms_kernel", 7),
                max_centers=engine_params.get("max_centers", 256))[0]
            meters.evaluate(
                {"sem_logits": out["sem_logits"], "pan_seg": pred_pan},
                {"sem": tgt_sem[None], "pan_seg": tgt_pan.cpu().numpy()})

        averages = {
            f"{meters.class_names.get(l, l)}_{mname}": float(v)
            for mname, metric in meters.metrics_dict.items()
            for l, v in metric.average().items()}
        if logger is not None and averages:
            logger.log_metrics(averages, step=epoch)
        for k, v in averages.items():
            print(f"eval {k}: {v:.4f}")
        return averages

    # --- loop -------------------------------------------------------

    def fit(self, epochs=None, loader=None, log_fn=print, logger=None,
            on_step=None):
        """Train from ``start_epoch`` to ``epochs`` (default: the
        schedule's), validating every EVAL.epochs_per_eval epochs and
        saving every TRAIN.save_freq (on rank 0; the other ranks wait).
        ``on_step(trainer, aux)`` runs after each step. Returns one dict of the last step's aux per
        epoch; ``self.timeline`` gets one {epoch, step, data_wait, end}
        per step (host clock)."""
        tcfg = self.config["TRAIN"]
        loader = loader or self.build_loader()
        steps_per_epoch = len(loader)
        if steps_per_epoch == 0:
            raise ValueError(
                "empty training loader: fewer images than batch_size "
                f"({self.batch_size}) with drop_last; add data or reduce "
                "TRAIN.batch_size")
        if self.optimizer is None:
            self.init_state(steps_per_epoch)
        epochs = epochs or tcfg.get("schedule_params", {}).get("epochs", 1)
        print_freq = tcfg.get("print_freq", 50)
        save_freq = tcfg.get("save_freq", 1)
        model_dir = tcfg.get("model_dir", ".")
        epochs_per_eval = (self.config.get("EVAL") or {}).get(
            "epochs_per_eval", 0)

        history = []
        for epoch in range(self.start_epoch, epochs):
            loader.set_epoch(epoch)
            t0 = last = time.time()
            data_t = 0.0
            for i, batch in enumerate(loader):
                wait = time.time() - last
                data_t += wait
                aux = self.train_step(batch)
                if on_step is not None:
                    on_step(self, aux)
                if (i + 1) % print_freq == 0 or (i + 1) == steps_per_epoch:
                    log_fn(f"Epoch [{epoch}][{i + 1}/{steps_per_epoch}] "
                           f"lr {self.lr_schedule(self.step):.2e} "
                           + " ".join(f"{k} {float(v):.4f}"
                                      for k, v in aux.items()))
                last = time.time()
                self.timeline.append({"epoch": epoch, "step": self.step,
                                      "data_wait": wait, "end": last})
            log_fn(f"Epoch {epoch} done in {time.time() - t0:.1f}s "
                   f"(data wait {data_t:.1f}s)")
            epoch_metrics = {k: float(v) for k, v in aux.items()}
            history.append(epoch_metrics)
            if logger is not None:
                logger.log_metrics(epoch_metrics, step=epoch)
            if self.rank == 0 and epochs_per_eval \
                    and (epoch + 1) % epochs_per_eval == 0:
                self.validate(logger=logger, epoch=epoch)
            if self.rank == 0 and (epoch + 1) % save_freq == 0:
                self.save(self.checkpoint_path(), epoch + 1,
                          run_id=getattr(logger, "run_id", None))
            if self.world > 1:
                torch.distributed.barrier()
        return history

    def checkpoint_path(self):
        tcfg = self.config["TRAIN"]
        return os.path.join(tcfg.get("model_dir", "."),
                            f"{tcfg.get('run_name', 'model')}_checkpoint.pth")

    def save(self, path, epoch, run_id=None):
        save_checkpoint(
            path,
            {"model": self.model.state_dict(),
             "optimizer": self.optimizer.state_dict(),
             "scheduler": self.scheduler.state_dict(),
             "step": self.step, "epoch": epoch},
            metadata={
                "epoch": epoch,
                "arch": self.arch,
                "norms": self.norms,
                "model_config": self.config.get("MODEL", {}),
                "run_id": run_id or getattr(self, "resume_run_id", None),
            })
        print(f"=> saved checkpoint {path}")


def _save_eval_snapshot(logger, epoch, index, image, pan_seg):
    """Side-by-side image / panoptic-id PNG logged as a run artifact."""
    from empanada_torch.data.image_files import write_png

    img = np.asarray(image)
    img = img[..., 0] if img.ndim == 3 else img
    img = ((img - img.min()) / max(float(np.ptp(img)), 1e-6) * 255)
    seg = (pan_seg % 251).astype(np.int64) * 83 % 255
    panel = np.concatenate([img, seg], axis=1).astype(np.uint8)
    path = os.path.join(logger.artifact_path("snapshots"),
                        f"eval_e{epoch}_i{index}.png")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, panel)
    logger.log_artifact(path)


def _build_meters(metric_specs, class_names):
    metric_dict = {}
    for spec in metric_specs:
        params = {k: v for k, v in spec.items()
                  if k not in ("metric", "name")}
        metric_dict[spec["name"]] = metrics_mod.create_metric(
            spec["metric"], metrics_mod.EMAMeter, **params)
    return metrics_mod.ComposeMetrics(metric_dict, class_names)
