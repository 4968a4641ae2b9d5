"""Blocked stack inference: the whole per-slice pipeline over B slices.

Each block of B slices runs, on the device and without host
synchronization: normalize -> model forward -> softmax/sigmoid ->
z-median (the window crosses block boundaries through carried device
state) -> center NMS -> pixel grouping (ONE kernel launch per block) ->
coarse panoptic merge -> foreground run extraction. The block leaves
the device as one packed int32 buffer (B, 1 + max_runs, 3) whose header
row is (n_runs, oh, ow); the copy to the host is started at dispatch
time (pinned buffer + CUDA event), so up to ``pipeline_depth`` blocks
stay in flight while the host matches earlier ones.

Two ways to feed the blocks, one device step for both
(``_block_step``): ``infer_blocks`` streams a dataset's slices (read and
padded on a prefetch thread, one upload a block), and
``infer_blocks_resident`` takes the whole volume on the device (one
upload, or z-chunks double-buffered on a side stream) and slices and pads
each block there (the caller orients an axis: ``torch.movedim`` on the
device, ``np.moveaxis`` on the host).

Emission semantics match the JAX engine exactly: slice z gets the window
median for mid <= z < n - mid and its raw map at the stack edges.
Maps and run coordinates stay on the factor-padded grid; the header
carries the true crop for the host rebase (rle.unpack_packed_runs).

On a CUDA device without a mesh, the block step is one CUDA graph,
captured on the first block of a shape and replayed for every block of
every pass with that shape: one launch a block instead of a thousand.
What changes between blocks reaches the graph through static buffers:
the batch, the scalars (block_start, n, oh, ow) on the device, and the
median window's carry, which the step rewrites in place. The graphs
are kept per module (an engine is built per call), keyed on everything
the capture bakes in. On the CPU, with a mesh, where the capture
raised, or while another pass holds the graph, the same step runs
eagerly.

With ``mesh=`` (``parallel.create_mesh``) each block is split into
``mesh.size`` contiguous chunks, each device runs its own replica of
the model on its chunk (the launches are asynchronous, so one host
thread keeps every card busy), and the maps are gathered onto the
mesh's first device, where the median window, the postprocess, the
grouping kernel and the run extraction run exactly as without a mesh.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from empanada_torch.device import resolve_device
from empanada_torch.ops import group
from empanada_torch.ops.postprocess import (
    find_instance_centers,
    group_pixels,
    harden_semantic,
    logits_to_prob,
    median_small,
    merge_semantic_and_instance,
    merge_semantic_and_instance_coarse,
    thing_table,
)
from empanada_torch.ops.resize import factor_pad
from empanada_torch.ops.rle_device import extract_fg_runs
from empanada_torch.parallel.mesh import replicate, shard_batch
from empanada_torch.utils import profiling

__all__ = ["FusedStackEngine", "CHUNK_BYTES"]

# the resident path's default chunk: whole blocks of at most this many
# bytes of raw volume on the device (two while the next one uploads)
CHUNK_BYTES = 2 << 30

# captured block steps, {module: {key: graph, or None where the capture
# raised}}: an engine is built per call, the module outlives it
_GRAPHS = weakref.WeakKeyDictionary()
_GRAPHS_LOCK = threading.Lock()


class _HostPacked:
    """A block's packed buffer on its way to the host: ``np.asarray``
    waits for the copy (CUDA event) and returns the (B, 1+R, 3) array."""

    def __init__(self, host, event=None):
        self._host = host
        self._event = event

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            with profiling.span("infer.d2h_wait"):
                self._event.synchronize()
            self._event = None
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype)


class _DeviceMaps:
    """A block's (B, ph, pw) pan maps left on the device. Consumers touch
    them only on run-budget overflow; indexing pulls one slice."""

    def __init__(self, maps):
        self._maps = maps

    @property
    def shape(self):
        return tuple(self._maps.shape)

    def __len__(self):
        return self._maps.shape[0]

    def __getitem__(self, j):
        return self._maps[j].cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self._maps.cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class FusedStackEngine:
    """Blocked, fused 3D stack inference engine.

    ``module``: an ``nn.Module`` honoring the engine contract — called as
    ``module(x, render_steps=, interpolate_ins=)`` on (B, 1, H, W)
    float32 images, it returns NCHW ``sem_logits`` at H*2^(render_steps-2)
    and ``ctr_hmp``/``offsets`` at 1/4 resolution when coarse.
    ``variables``: None, or a state_dict loaded into ``module``.
    ``device_norms=(mean, std)`` or {"mean", "std"}: normalize on the
    device, ((x/255 - mean)/std) with the factor-pad ring re-zeroed; feed
    RAW (e.g. uint8) slices. ``device``: CUDA unless named (raises
    without a card when none is named). ``mesh``: shard each block's
    forward over the mesh's devices (``block_size`` must divide over
    it); the engine then runs on the mesh's first device.

    ``infer_blocks(dataset)`` and ``infer_blocks_resident(volume)``
    yield (z_indices, pan_block, packed) per block; ``packed`` converts
    with ``np.asarray`` to the (B, 1+R, 3) int32 buffer, ``pan_block``
    holds the padded (B, ph, pw) maps. ``infer_stack(dataset)`` yields
    the same slice by slice in the true crop shape.
    ``block_cost_analysis()`` counts a block's FLOPs.
    """

    def __init__(self, module, variables, thing_list, block_size=None,
                 label_divisor=1000, stuff_area=64, void_label=0,
                 nms_threshold=0.1, nms_kernel=7, confidence_thr=0.5,
                 median_kernel_size=3, padding_factor=128,
                 coarse_boundaries=True, max_centers=256,
                 num_classes=None, max_runs=None, device_norms=None,
                 pipeline_depth=2, device=None, mesh=None):
        assert median_kernel_size % 2 == 1
        if mesh is not None:
            if block_size is not None and block_size % mesh.size:
                raise ValueError(
                    f"block_size {block_size} must divide over the "
                    f"{mesh.size}-device mesh")
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if variables:
            module.load_state_dict(variables)
        self.mesh = mesh
        self.module = module.to(self.device).eval()
        self.devices = mesh.devices if mesh is not None else (self.device,)
        self.replicas = replicate(self.module, mesh) if mesh is not None \
            else [self.module]
        self.thing_list = list(thing_list)
        self.block_size = block_size
        self.label_divisor = label_divisor
        self.stuff_area = stuff_area
        self.void_label = void_label
        self.nms_threshold = nms_threshold
        self.nms_kernel = nms_kernel
        self.confidence_thr = confidence_thr
        self.ks = median_kernel_size
        self.mid = (median_kernel_size - 1) // 2
        self.padding_factor = padding_factor
        self.coarse_boundaries = coarse_boundaries
        self.max_centers = max_centers
        self.max_runs = max_runs
        self.device_norms = device_norms
        self.pipeline_depth = int(pipeline_depth)
        self.last_dispatch_count = 0  # blocks run in the last pass
        self._num_classes = num_classes
        self._cost_pass = None  # the largest pass run (block_cost_analysis)

    # -----------------------------------------------------------------

    def _resolve_block(self, pad_shape, n):
        """Slices per block for this slice shape: the explicit setting
        if given, else ~8 512^2-slices of pixels per device (rounded to
        a multiple of 8 a device, at most 64 a device), clamped to the
        stack length rounded up to a multiple of 8 and of the mesh."""
        mf = self.mesh.size if self.mesh is not None else 1
        if self.block_size is not None:
            return self.block_size
        ph, pw = pad_shape
        B = 8 * (512 * 512) * mf / max(ph * pw, 1)
        B = max(8 * mf, min(64 * mf, round(B / (8 * mf)) * 8 * mf))
        need = n + self.mid
        if B > need:
            B = min(B, -(-(-(-need // 8) * 8) // mf) * mf)
        return B

    def _auto_max_runs(self, H, W):
        """Packed-run budget for a padded slice of H x W (sem res): an
        instance-count term (~one run per row an instance spans) and an
        area term H*W/16 for dense content."""
        return max(4096, 8 * H, max(24, H // 21) * self.max_centers,
                   (H * W) // 16)

    def _norms(self):
        norms = self.device_norms
        if norms is None:
            return None
        mean = float(norms["mean"] if isinstance(norms, dict) else norms[0])
        std = float(norms["std"] if isinstance(norms, dict) else norms[1])
        return mean, std

    @staticmethod
    def _pad_mask(crop, pad_shape, upsampling):
        """(ph, pw) float mask of the true image area: ``crop`` is the
        true (oh, ow) at full resolution, a (2,) int32 tensor."""
        ph, pw = pad_shape
        ny, nx = (crop + (upsampling - 1)) // upsampling
        rows = torch.arange(ph, device=crop.device) < ny
        cols = torch.arange(pw, device=crop.device) < nx
        return (rows[:, None] & cols[None, :]).float()

    def _forward(self, batch, render_steps, norms, pad_mask):
        """(B, ph, pw) host batch -> float32 probabilities (B, C, H, W),
        centers (B, h4, w4) and offsets (B, h4, w4, 2) on the engine's
        device. The model takes float32 images and computes in its own
        dtype. Each replica runs its contiguous chunk on its own device,
        and the chunks are gathered onto the first."""
        chunks = shard_batch(batch, self.mesh) if self.mesh is not None \
            else [batch.to(self.device, non_blocking=True)]
        outs = []
        for module, x in zip(self.replicas, chunks):
            x = x[:, None].float()
            if norms is not None:
                x = (x / 255.0 - norms[0]) / norms[1]
                x = x * pad_mask.to(x.device, non_blocking=True)
            out = module(x, render_steps=render_steps,
                         interpolate_ins=not self.coarse_boundaries)
            # the probabilities in the model's dtype, then float32 (the
            # JAX block function's concatenation with the float32 carry)
            outs.append((logits_to_prob(out["sem_logits"]).float(),
                         out["ctr_hmp"][:, 0].float(),
                         out["offsets"].permute(0, 2, 3, 1).float()))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[k].to(self.device, non_blocking=True)
                                for o in outs]) for k in range(3))

    def _postprocess(self, sem_prob, ctr, off, num_classes, upsampling,
                     max_runs, crop, table):
        """(B, C, H, W) probs, (B, h4, w4) centers, (B, h4, w4, 2)
        offsets -> (B, H, W) pan maps and (B, 1+max_runs, 3) packed.
        ``crop``: the true (oh, ow), a (2,) int32 tensor on the device."""
        step = 4 if self.coarse_boundaries else 1
        scale = step * upsampling
        oh, ow = crop
        centers, valid = find_instance_centers(
            ctr, self.nms_threshold, self.nms_kernel, self.max_centers)
        ins = group_pixels(centers, valid, off, step=float(step))
        ins = torch.where(valid.any(dim=1)[:, None, None], ins,
                          torch.zeros_like(ins))
        sem = harden_semantic(sem_prob, self.confidence_thr)
        if scale > 1:
            pan = merge_semantic_and_instance_coarse(
                sem, ins, scale, self.label_divisor, table,
                self.stuff_area, self.void_label, self.max_centers,
                num_classes)
        else:
            pan = merge_semantic_and_instance(
                sem, ins, self.label_divisor, table, self.stuff_area,
                self.void_label, self.max_centers, num_classes)
        b, H, W = pan.shape
        # stay on the padded grid; zero the margin so it adds no runs
        rows = torch.arange(H, device=pan.device)[:, None] < oh
        cols = torch.arange(W, device=pan.device)[None, :] < ow
        pan = torch.where(rows & cols, pan, torch.zeros_like(pan))
        starts, ends, values, n_runs = extract_fg_runs(pan, max_runs)
        header = torch.stack([n_runs, oh.expand_as(n_runs),
                              ow.expand_as(n_runs)], dim=1)
        packed = torch.cat([header[:, None],
                            torch.stack([starts, ends, values], dim=-1)],
                           dim=1)
        return pan, packed

    def _to_host(self, packed):
        """Start the block's one device->host copy; returns _HostPacked."""
        if packed.device.type != "cuda":
            return _HostPacked(packed)
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(packed.device))
        return _HostPacked(host, event)

    # -----------------------------------------------------------------

    def _prepare(self, pad_shape, crop, n, upsampling):
        """The constants of one pass over n slices of true size ``crop``,
        padded to ``pad_shape`` (sem resolution ``upsampling`` times
        that)."""
        assert math.log2(upsampling).is_integer()
        ph, pw = pad_shape
        B = self._resolve_block(pad_shape, n)
        if self._num_classes is None:
            self._num_classes = max(
                int(getattr(self.module, "num_classes", 1)),
                (max(self.thing_list) + 1) if self.thing_list else 1, 2)
        return SimpleNamespace(
            n=n, B=B, pad_shape=pad_shape, crop=crop, upsampling=upsampling,
            pixels=B * ph * pw * upsampling ** 2,
            render_steps=int(2 + math.log2(upsampling)),
            num_classes=self._num_classes,
            max_runs=self.max_runs or self._auto_max_runs(
                ph * upsampling, pw * upsampling),
            norms=self._norms(),
            table=thing_table(self.thing_list, self._num_classes,
                              self.device))

    def _zero_carry(self, p):
        """The median window's carry before a pass's first block: ks - 1
        maps of sem probabilities, mid of centers and offsets."""
        ph, pw = p.pad_shape
        h4, w4 = (ph // 4, pw // 4) if self.coarse_boundaries else (ph, pw)
        dev = self.device
        return (torch.zeros((self.ks - 1,
                             getattr(self.module, "num_classes", 1),
                             ph * p.upsampling, pw * p.upsampling),
                            device=dev),
                torch.zeros((self.mid, h4, w4), device=dev),
                torch.zeros((self.mid, h4, w4, 2), device=dev))

    def _buffers(self, p):
        """A pass's device state: the scalars (block_start, n, oh, ow),
        int32, and the median window's carry."""
        return SimpleNamespace(
            scalars=torch.zeros(4, dtype=torch.int32, device=self.device),
            carry=self._zero_carry(p))

    @staticmethod
    def _start_pass(bufs, p):
        """Zero the carry and set n and the crop, on the device's stream
        and without a copy from the host."""
        for t in bufs.carry:
            t.zero_()
        for i, v in enumerate((p.n,) + tuple(p.crop), start=1):
            bufs.scalars[i].fill_(v)

    def _block_step(self, p, batch, scalars, carry):
        """One block on the device: the (B, ph, pw) batch of slices
        block_start .. block_start + B - 1 -> forward -> z-median window
        (the previous blocks' maps come in ``carry``) -> postprocess ->
        (pan maps, packed runs); ``carry`` is rewritten in place for the
        next block. ``scalars``: (block_start, n, oh, ow), an int32
        tensor on the device, so that neither a value nor a branch of the
        step depends on them on the host. The block emits slice z =
        block_start + j - mid: its window median for mid <= z < n - mid,
        its raw map at the stack edges."""
        ks, mid, B = self.ks, self.mid, p.B
        block_start, n, crop = scalars[0], scalars[1], scalars[2:]
        pad_mask = (self._pad_mask(crop, p.pad_shape, p.upsampling)
                    if p.norms is not None else None)
        sem, ctr, off = self._forward(batch, p.render_steps, p.norms,
                                      pad_mask)
        carry_sem, carry_ctr, carry_off = carry
        allsem = torch.cat([carry_sem, sem], dim=0)
        allctr = torch.cat([carry_ctr, ctr], dim=0)
        alloff = torch.cat([carry_off, off], dim=0)
        # window j = allsem[j : j+ks]; emitted slice sits at j+mid
        win = allsem.unfold(0, ks, 1)[:B]      # (B, C, H, W, ks)
        med = median_small(win, dim=-1)
        raw = allsem[mid:mid + B]
        z = torch.arange(B, dtype=torch.int32, device=allsem.device) \
            + (block_start - mid)
        use_median = (z >= mid) & (z < n - mid)
        emit_sem = torch.where(use_median[:, None, None, None], med, raw)
        pan, packed = self._postprocess(
            emit_sem, allctr[:B], alloff[:B].contiguous(), p.num_classes,
            p.upsampling, p.max_runs, crop, p.table)
        carry_sem.copy_(allsem[B:])
        carry_ctr.copy_(allctr[B:])
        carry_off.copy_(alloff[B:])
        return pan, packed

    # -----------------------------------------------------------------

    def _graph_key(self, p, batch):
        """Everything a captured step bakes in: the pass's shapes and
        dtypes, the engine's settings, and the module's tensors by
        address, shape and dtype, so that a module whose tensors were
        replaced is captured anew (values changed in place are read by
        the replays as they are)."""
        tensors = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                        for t in itertools.chain(self.module.parameters(),
                                                 self.module.buffers()))
        return (self.device, p.pad_shape, p.B, p.upsampling, batch.dtype,
                p.norms, p.num_classes, p.max_runs, tuple(self.thing_list),
                self.label_divisor, self.stuff_area, self.void_label,
                self.nms_threshold, self.nms_kernel, self.confidence_thr,
                self.ks, self.coarse_boundaries, self.max_centers,
                getattr(self.module, "num_classes", 1), tensors)

    def _claim_graph(self, p, batch):
        """The captured step for this pass, held until the pass ends
        (captured here on the key's first pass); None where the pass runs
        eagerly: the key's capture raised, or another open pass holds
        its graph. Graphs of the module's replaced tensors are dropped."""
        key = self._graph_key(p, batch)
        with _GRAPHS_LOCK:
            graphs = _GRAPHS.setdefault(self.module, {})
            for stale in [k for k in graphs if k[-1] != key[-1]]:
                del graphs[stale]
            if key not in graphs:
                graphs[key] = self._capture(p, batch)
            graph = graphs[key]
            if graph is None or graph.busy:
                return None
            graph.busy = True
            return graph

    def _capture(self, p, batch):
        """Capture the block step of ``p`` as a CUDA graph with its own
        memory pool, on a side stream after one eager warm-up run (its
        grouping launch is real and counts); None where the capture
        raises, as it does for a module that waits for the device."""
        dev = self.device
        profiling.count("infer.graph_capture")
        with profiling.span("infer.capture"):
            graph = self._buffers(p)
            graph.batch = torch.zeros(batch.shape, dtype=batch.dtype,
                                      device=dev)
            graph.table = p.table  # read by the replays
            self._start_pass(graph, p)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._block_step(p, graph.batch, graph.scalars, graph.carry)
            torch.cuda.synchronize(dev)
            graph.graph = torch.cuda.CUDAGraph()
            pool = torch.cuda.graph_pool_handle()
            before = group.LAUNCHES["group_pixels"]
            try:
                # thread_local: the other threads (prefetch, decode, the
                # host half) keep using the device meanwhile
                with torch.cuda.stream(side):
                    graph.graph.capture_begin(
                        pool=pool, capture_error_mode="thread_local")
                    try:
                        graph.pan, graph.packed = self._block_step(
                            p, graph.batch, graph.scalars, graph.carry)
                    finally:
                        graph.graph.capture_end()
            except RuntimeError:
                # a capture that raised leaves the allocator sending the
                # pool's allocations to it (torch 2.11); end that and
                # free the pool
                with contextlib.suppress(RuntimeError):
                    torch._C._cuda_endAllocateToPool(dev.index, pool)
                torch._C._cuda_releasePool(dev.index, pool)
                return None
            finally:
                # the capture recorded the grouping launches and ran none
                graph.launches = group.LAUNCHES["group_pixels"] - before
                group.count_launches(dev.index, -graph.launches)
            torch.cuda.current_stream(dev).wait_stream(side)
        graph.busy = False
        return graph

    @contextlib.contextmanager
    def _pass(self, p):
        """The block step of one pass, (block_start, batch) -> (pan,
        packed), with the carry zeroed at its start. On a CUDA device
        without a mesh it replays the pass's graph (``_claim_graph``):
        the batch is copied into the graph's own, and pan comes out as a
        copy, so that a block in flight keeps its maps; packed is the
        graph's, valid until the next step (``_to_host``'s copy, queued
        after the replay, goes first). Otherwise the step runs eagerly.
        Counters: ``infer.graph_replay`` a replayed block,
        ``infer.graph_eager`` a block run eagerly on a CUDA device."""
        cuda = self.device.type == "cuda"
        graph = bufs = None

        def step(block_start, batch):
            nonlocal graph, bufs
            if bufs is None:
                if cuda and self.mesh is None:
                    graph = self._claim_graph(p, batch)
                bufs = graph if graph is not None else self._buffers(p)
                self._start_pass(bufs, p)
            bufs.scalars[0].fill_(block_start)
            if graph is None:
                if cuda:
                    profiling.count("infer.graph_eager")
                return self._block_step(p, batch, bufs.scalars, bufs.carry)
            graph.batch.copy_(batch, non_blocking=True)
            graph.graph.replay()
            profiling.count("infer.graph_replay")
            group.count_launches(self.device.index, graph.launches)
            return graph.pan.clone(), graph.packed

        try:
            yield step
        finally:
            if graph is not None:
                with _GRAPHS_LOCK:
                    graph.busy = False

    def _blocks(self, p, batches):
        """Run one pass's blocks in order and yield (z_indices, pan maps,
        packed) with up to ``pipeline_depth`` blocks in flight.
        ``batches`` yields (block_start, (B, ph, pw) batch) for the block
        starts range(0, n + mid, B)."""
        mid = self.mid
        depth = max(self.pipeline_depth, 0)
        inflight = deque()
        self.last_dispatch_count = 0
        with self._pass(p) as step:
            for block_start, batch in batches:
                with profiling.span("infer.dispatch"):
                    pan, packed = step(block_start, batch)
                    host = self._to_host(packed)
                self.last_dispatch_count += 1
                if self._cost_pass is None \
                        or p.pixels > self._cost_pass.pixels:
                    self._cost_pass = p
                z_indices = [block_start + j - mid
                             if 0 <= block_start + j - mid < p.n else None
                             for j in range(p.B)]
                inflight.append((z_indices, _DeviceMaps(pan), host))
                while len(inflight) > depth:
                    yield inflight.popleft()
            while inflight:
                yield inflight.popleft()

    def infer_stack(self, dataset, upsampling=1):
        """Per-slice view of ``infer_blocks``: yields (z, pan_slice,
        (starts, ends, values, n_runs)) in z order, for tests and small
        volumes (each slice's map is its own copy to the host; the
        orthoplane path consumes whole blocks). The map and the run
        coordinates are in the true crop shape, rebased on the host from
        the blocks' factor-padded grid; on run-budget overflow the runs
        are the buffer's rows as they are and the map is the one to
        read."""
        from empanada_torch.inference.rle import unpack_packed_runs

        for z_indices, pan, packed in self.infer_blocks(dataset, upsampling):
            arr = np.asarray(packed)
            pad_shape = tuple(pan.shape[-2:])
            for j, z in enumerate(z_indices):
                if z is None:
                    continue
                n_runs = arr[j, 0, 0]
                starts, ends, values, (oh, ow) = unpack_packed_runs(
                    arr[j], pad_shape)
                if starts is None:
                    starts, ends, values = arr[j, 1:].T
                yield z, pan[j][:oh, :ow], (starts, ends, values, n_runs)

    @torch.inference_mode()
    def infer_blocks(self, dataset, upsampling=1):
        """Stream the dataset's slices through the blocks: a prefetch
        thread reads and pads each block on the host (pinned), and the
        block uploads when it runs."""
        n = len(dataset)
        pf = self.padding_factor
        with profiling.span("infer.setup"):
            ex0 = dataset[0]
            img0 = np.asarray(ex0["image"])
            if self.device_norms is None and img0.dtype != np.float32:
                img0 = img0.astype(np.float32)
            p = self._prepare((img0.shape[0] + (-img0.shape[0]) % pf,
                               img0.shape[1] + (-img0.shape[1]) % pf),
                              tuple(int(s) for s in ex0["size"]), n,
                              upsampling)
        call = profiling.current_call()

        def load_block(block_start):
            """Read + pad one block of slices on the prefetch thread."""
            with profiling.span("infer.load", call):
                images = []
                for src in range(block_start, block_start + p.B):
                    if src < n:
                        img = np.asarray(
                            (dataset[src] if src else ex0)["image"])
                        if self.device_norms is None \
                                and img.dtype != np.float32:
                            img = img.astype(np.float32)
                    else:
                        img = np.zeros_like(img0)
                    images.append(img)
                batch, _ = factor_pad(np.stack(images), pf)
                batch = torch.from_numpy(np.ascontiguousarray(batch))
                # async uploads need pinned buffers
                return batch.pin_memory() if self.device.type == "cuda" \
                    else batch

        def batches(pool):
            starts = iter(range(0, n + self.mid, p.B))
            queue = deque((s, pool.submit(load_block, s)) for s in
                          itertools.islice(starts,
                                           max(self.pipeline_depth, 0) + 2))
            while queue:
                block_start, fut = queue.popleft()
                with profiling.span("infer.load_wait"):
                    batch = fut.result()
                nxt = next(starts, None)
                if nxt is not None:
                    queue.append((nxt, pool.submit(load_block, nxt)))
                yield block_start, batch

        pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="infer-load")
        try:
            yield from self._blocks(p, batches(pool))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    @torch.inference_mode()
    def infer_blocks_resident(self, volume, upsampling=1,
                              chunk_slices=None):
        """``infer_blocks`` over a whole (n, h, w) volume held on the
        device, with the same yield contract and exactly the same maps
        and runs: each block is sliced, padded and made contiguous on the
        device, so no block goes through the host.

        ``volume``: a host ndarray, uploaded in z-chunks of
        ``chunk_slices`` (rounded down to a multiple of the block, at
        least one block; by default as many whole blocks as fit in
        ``CHUNK_BYTES``), the next chunk uploading on a side stream while
        the current one computes; or a tensor already on the engine's
        device (an axis oriented with ``torch.movedim``), sliced in
        place. The caller orients the axis; leave the dtype native
        (uint8 with ``device_norms``; without them the volume is cast to
        float32). One device and full-resolution slices only."""
        if self.mesh is not None:
            raise ValueError("the resident path runs on one device; a "
                             "mesh streams its blocks (infer_blocks)")
        if upsampling != 1:
            raise ValueError("the resident path takes full-resolution "
                             "slices; downsampled passes use "
                             "infer_blocks(dataset, upsampling=)")
        dev = self.device
        on_device = isinstance(volume, torch.Tensor)
        if on_device and volume.device != dev:
            raise ValueError(f"volume on {volume.device}, engine on {dev}")
        if self.device_norms is None:
            volume = volume.float() if on_device \
                else np.asarray(volume, np.float32)
        n, oh, ow = volume.shape
        pf = self.padding_factor
        ph, pw = oh + (-oh) % pf, ow + (-ow) % pf
        with profiling.span("infer.setup"):
            p = self._prepare((ph, pw), (oh, ow), n, upsampling)
        B = p.B
        if chunk_slices is None:
            per_slice = oh * ow * (volume.element_size() if on_device
                                   else volume.itemsize)
            chunk_len = max(B, CHUNK_BYTES // max(per_slice, 1) // B * B)
        else:
            chunk_len = max(B, chunk_slices // B * B)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" \
            and not on_device else None

        def upload(c0):
            """Chunk [c0, c0 + chunk_len) of the volume on the device (no
            slice where it starts past the volume's end), and the event
            its upload records (None where nothing is copied
            asynchronously)."""
            part = volume[c0:min(c0 + chunk_len, n)]
            if on_device:
                return part, None
            host = torch.from_numpy(np.require(part, requirements="CW"))
            if side is None or not host.numel():
                return host.to(dev), None
            host = host.pin_memory()
            with torch.cuda.stream(side):
                chunk = host.to(dev, non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record(side)
            return chunk, uploaded

        def batches():
            chunks = {}
            for block_start in range(0, n + self.mid, B):
                ci = block_start // chunk_len
                for c in (ci, ci + 1):  # the next chunk uploads meanwhile
                    if c not in chunks and c * chunk_len < n + self.mid:
                        chunks[c] = upload(c * chunk_len)
                # the previous chunk's last block is enqueued: the
                # allocator reuses its memory only after that work ends
                chunks.pop(ci - 1, None)
                chunk, uploaded = chunks[ci]
                if uploaded is not None:
                    compute = torch.cuda.current_stream(dev)
                    compute.wait_event(uploaded)
                    chunk.record_stream(compute)
                    chunks[ci] = (chunk, None)
                part = chunk[block_start - ci * chunk_len:][:B]
                yield block_start, F.pad(
                    part, (0, pw - ow, 0, ph - oh, 0, B - len(part)))

        yield from self._blocks(p, batches())

    def block_cost_analysis(self):
        """{"flops": n} of one block of the largest shape run so far
        (forward and postprocess, counted once on zeros by
        ``torch.utils.flop_counter.FlopCounterMode``), or None before the
        first block. The count covers convolutions and matrix products
        (2 operations a multiply-add); XLA's cost analysis of the JAX
        package's block function also counts elementwise operations, so
        the two differ by those and neither is wrong. A count runs the
        block once more on the device (its grouping launch counts)."""
        from torch.utils.flop_counter import FlopCounterMode

        p = self._cost_pass
        if p is None:
            return None
        batch = torch.zeros((p.B,) + p.pad_shape, device=self.device)
        counter = FlopCounterMode(display=False)
        with torch.inference_mode():
            bufs = self._buffers(p)
            self._start_pass(bufs, p)
            with counter:  # eager, never a graph: the counter sees each op
                self._block_step(p, batch, bufs.scalars, bufs.carry)
        return {"flops": counter.get_total_flops()}
