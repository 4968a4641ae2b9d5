"""Training cells: ``Trainer.train_step`` of the configuration's recipe on
batches of the traffic's crops.

Set-up makes the weights and a pool of distinct batches from the seed,
builds one ``Trainer``, loads the weights, and drives its first steps
(``check_steps``) through the window's own call, keeping what the
output check compares; those steps take the pool's PointRend points,
which the reference takes too. The same trainer then trains on through
the window, cycling through the pool, each step drawing its points by
the program's own importance sampler (the recipe's oversampling and
top-k), with work dispatched ahead; the
device is synchronised at the window's two ends. The window closes with
the first step dispatched at or after ``seconds``. After it, the program
is freed and the plain reference trains from the same weights through
the same first batches; the comparison decides ``correct``.
"""

from __future__ import annotations

import copy
import gc
import sys
import time

import torch

from portbench import check, gen, weights
from portbench.flops import train_step_flops
from portbench.reference import models as ref_models
from portbench.reference.train import run_steps
from portbench.spec import HERE, load_reference
from portbench.trace import WINDOW, Tracer

__all__ = ["recipe", "state_shapes", "make_weights", "program_steps",
           "reference_steps", "run", "readings", "Faults"]

def recipe(cfg, traffic):
    """The program's recipe dict for this cell."""
    r = copy.deepcopy(cfg["recipe"])
    r["TRAIN"]["batch_size"] = traffic["batch"]
    r["TRAIN"]["schedule_params"]["epochs"] = 1
    r["TRAIN"]["schedule_params"]["steps_per_epoch"] = \
        traffic["schedule_steps"]
    return r


def state_shapes(cfg, base=HERE):
    model = ref_models.build(cfg, "meta", base=base)
    return {k: (tuple(v.shape), v.dtype) for k, v in
            model.state_dict().items()}


def make_weights(cfg, seed, device, base=HERE):
    """The recipe's initial weights from the seed, by ``weights.RULES``
    after the ``INIT_RULES`` of the configuration's reference module."""
    rules = getattr(load_reference(cfg, base), "INIT_RULES", ())
    return weights.make_state(state_shapes(cfg, base),
                              gen.sub_seed(seed, "weights"), device,
                              cfg["recipe"]["MODEL"]["num_fc"], rules)


def _norms(named):
    """{name: float norm} with one transfer to the host."""
    names = list(named)
    if not names:
        return {}
    norms = torch.stack([named[n].float().norm() for n in names]).tolist()
    return dict(zip(names, norms))


class Faults:
    """Faults planted under the timed call (tests only): ``unchanged``
    restores the state after every step; ``half_batch`` trains on the
    first half of each batch's rows."""

    def __init__(self, unchanged=False, half_batch=False):
        self.unchanged, self.half_batch = unchanged, half_batch

    def step(self, trainer, batch, coords=None):
        if self.half_batch:
            n = len(batch["image"]) // 2
            batch = {k: v[:n] for k, v in batch.items()}
            coords = None if coords is None else coords[:n]
        if self.unchanged:
            saved = copy.deepcopy(trainer.model.state_dict())
            aux = trainer.train_step(batch, point_coords=coords)
            trainer.model.load_state_dict(saved)
            return aux
        return trainer.train_step(batch, point_coords=coords)


def program_steps(trainer, pool, init, steps, beta1, faults=None):
    """The program's first ``steps`` steps on the pool's first batches;
    returns its readings in ``reference.train.run_steps``'s form."""
    faults = faults or Faults()
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    losses, grad = [], None
    for i in range(steps):
        aux = faults.step(trainer, pool.batches[i], pool.coords[i])
        losses.append(aux["total_loss"])
        if i == 0:
            grad = _norms({names[id(p)]: s["exp_avg"] / (1 - beta1)
                           for p, s in trainer.optimizer.state.items()})
    params = dict(trainer.model.named_parameters())
    change = _norms({n: params[n].detach() - init[n] for n in params})
    return {"loss": [float(x) for x in losses], "grad": grad,
            "change": change}


def reference_steps(cfg, rec, traffic, pool, seed, device, steps,
                    precision="fp32", rows=None):
    """The plain reference's readings over the same first steps."""
    dtype = cfg["recipe"]["MODEL"].get("dtype", "float32")
    mask_dtype = torch.bfloat16 if (dtype == "bfloat16" and
                                    torch.device(device).type == "cuda") \
        else torch.float32
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = ref_models.build(cfg, device, mask_dtype)
        model.load_state_dict(make_weights(cfg, seed, device))
        ref_models.set_precision(model, precision)
        torch.manual_seed(gen.sub_seed(seed, "dropout"))
        return run_steps(model, [pool.nchw(i, device) for i in range(steps)],
                         pool.coords[:steps], rec, traffic["schedule_steps"],
                         rows=rows)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


class Stamps:
    """Seconds of each set-up phase, printed to standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phase):
        now = time.perf_counter()
        print(f"portbench: {phase} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, seed, device, faults=None):
    """Weights, pool, trainer and its first steps; returns a dict."""
    from empanada_torch.train.trainer import Trainer

    cfg, traffic = cell.config, cell.traffic
    stamp = Stamps()
    rec = recipe(cfg, traffic)
    init = make_weights(cfg, seed, device)
    stamp("weights")
    pool = gen.training_pool(traffic, rec["DATASET"]["norms"], seed, device)
    stamp("pool")
    trainer = Trainer(rec, device=device, seed=seed)
    trainer.model.load_state_dict(init)
    trainer.init_state(traffic["schedule_steps"])
    stamp("trainer")
    beta1 = rec["TRAIN"]["optimizer_params"].get("betas", (0.9, 0.999))[0]
    torch.manual_seed(gen.sub_seed(seed, "dropout"))
    prog = program_steps(trainer, pool, init, traffic["check_steps"], beta1,
                         faults)
    stamp("first steps")
    # the window's steps draw their own points: warm that path too
    (faults or Faults()).step(trainer, pool.batches[traffic["check_steps"]
                                                    % len(pool)])
    sync(device)
    stamp("sampler warm-up")
    del init
    return {"trainer": trainer, "pool": pool, "program": prog, "recipe": rec}


def window(trainer, pool, start, seconds, tracer, faults=None,
           clock=time.perf_counter):
    """Steps from pool batch ``start`` on until one is dispatched at or
    after ``seconds``; returns (steps, window seconds, per-step ms from
    CUDA events when tracing, losses)."""
    faults = faults or Faults()
    trace = tracer.on
    device = next(trainer.model.parameters()).device
    cuda = device.type == "cuda"
    events = []
    losses = []
    sync(device)
    t0 = clock()
    if trace and cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    i, steps = start, 0
    while True:
        b = i % len(pool)
        with tracer.span("train_step"):
            aux = faults.step(trainer, pool.batches[b])
        losses.append(aux["total_loss"])
        if trace and cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        i, steps = i + 1, steps + 1
        if clock() - t0 >= seconds:
            break
    sync(device)
    elapsed = clock() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return steps, elapsed, step_ms, torch.stack(losses)


def run(cell, seed, seconds, trace, device, t_start, faults=None):
    """One run of the cell: set-up, window, output check. Returns the
    driver's result (see ``portbench.run``)."""
    traffic = cell.traffic
    state = setup(cell, seed, device, faults)
    trainer, pool = state["trainer"], state["pool"]
    prog, rec = state["program"], state["recipe"]
    del state
    sync(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    with Tracer(trace) as tracer:
        with tracer.span(WINDOW):
            steps, window_s, step_ms, losses = window(
                trainer, pool, traffic["check_steps"] + 1, seconds, tracer,
                faults)
    failed = int((~torch.isfinite(losses)).sum())
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del trainer, losses
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    stamp = Stamps()
    ref = reference_steps(cell.config, rec, traffic, pool, seed, device,
                          traffic["check_steps"])
    stamp("reference")
    numbers, where = check.train_numbers(prog, ref)
    # only the traced run's per-layer metrics read the operation count
    flops = train_step_flops(cell.config, traffic["batch"], traffic["crop"],
                             traffic["points"]) if trace else None
    return {
        "numbers": numbers, "where": where,
        "attempted": steps, "failed": failed,
        "end_to_end": {"train_images_per_s": steps * traffic["batch"]
                       / window_s, "setup_s": setup_s},
        "ctx": {"steps": steps, "window_s": window_s, "step_ms": step_ms,
                "flops_per_step": flops, "trace": tracer.result,
                "dtype": cell.config["recipe"]["MODEL"].get("dtype")},
        "memory_peak_bytes": peak,
    }


def readings(cell, seeds, control_seeds, device, emit, witness_seeds=()):
    """Calibration readings (``portbench.calibrate``): for each seed the
    program's first ``check_steps`` steps against the plain reference's
    (``program``); on the control seeds also the reference in float8
    (``control``) and on the first half of each batch's rows
    (``half_batch``) against it. ``witness_seeds`` is not read."""
    traffic = cell.traffic
    steps = traffic["check_steps"]
    for seed in seeds:
        t0 = time.perf_counter()
        state = setup(cell, seed, device)
        pool, prog, rec = state["pool"], state["program"], state["recipe"]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        ref = reference_steps(cell.config, rec, traffic, pool, seed, device,
                              steps)
        numbers, where = check.train_numbers(prog, ref)
        emit({"kind": "program", "seed": seed, "numbers": numbers,
              "where": where, "loss": prog["loss"], "ref_loss": ref["loss"],
              "seconds": time.perf_counter() - t0})
        if seed in control_seeds:
            half = slice(0, traffic["batch"] // 2)
            for kind, kw in (("control", {"precision": "fp8"}),
                             ("half_batch", {"rows": half})):
                other = reference_steps(cell.config, rec, traffic, pool,
                                        seed, device, steps, **kw)
                numbers, where = check.train_numbers(other, ref)
                emit({"kind": kind, "seed": seed, "numbers": numbers,
                      "where": where, "loss": other["loss"]})
        del pool
        gc.collect()
        torch.cuda.empty_cache()
