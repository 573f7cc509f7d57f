"""Wrapper around the paged-attention decode CUDA kernel (port of
``repro/kernels/paged_attention/ops.py::paged_attention``).

``paged_attention`` checks device, dtype, shape and contiguity, allocates
the output, launches the kernel on PyTorch's current stream and counts the
launch in :data:`LAUNCHES`.  ``paged_attention_state`` does the same for
the kernel's state variant (K2s: the raw flash-decoding state (acc, m, l),
not normalized), counted under its own key.  Backends, as the BitParticle
matmul's:

  ``auto``    the kernel for CUDA tensors, the plain version (``ref.py``)
              for CPU tensors;
  ``kernel``  the kernel; a CPU tensor raises;
  ``plain``   the plain version on any device (the card's A/B reference).

int8 KV scale pages: the kernel gathers float pages only, so ``auto`` takes
the plain gather for them, which is the reference's route too, and counts
each such call in :data:`ROUTED_PLAIN` (``"int8_kv"``); ``kernel`` with
scale pages raises.  Nothing falls back quietly: a failed build or launch
raises.

Each sequence's positions are split over several blocks, planned from
shapes only by :func:`split_plan` (the lengths stay on the device); the
last block of a (sequence, kv head) merges the splits through an int32
arrival counter that the kernel leaves zeroed (:func:`_counters`, one
buffer per device, grown on demand), so calls on one device must run on one
stream at a time: every host thread of the serving path launches on the
device's default stream (see ``bitparticle_matmul/ops.py``), and the
buffer's growth and the counts are guarded by a lock.  The state variant
shares the plan and the counters.

Under a mesh (``mesh=``, see ``launch/mesh.py``) the call is split as the
reference's ``shard_map`` splits it: the block tables' page dimension over
``"model"`` where it divides (split KV: shard s takes table columns [s P_l,
(s + 1) P_l) and the length rebased by s P_l bs, negative on a far shard,
runs the state variant, and the shards' states merge through
``sharding.combine_softmax_state``), and the batch over ``"data"`` where it
divides (a data shard without a KV split runs the plain kernel).  The page
pool is whole on the mesh's one device.  The shards launch one after
another on the default stream.  int8 KV scale pages take the plain gather
unsharded, as the reference takes its gather before it looks at the mesh.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels.build import KernelError, KernelInputError
from repro_torch.kernels.paged_attention import ref
from repro_torch.launch import op_analysis

BACKENDS = ("auto", "plain", "kernel")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: K/V rows of one stage of the kernel's ring (8 warps x 16 rows)
STAGE_ROWS = 128
#: query rows of one kv head that one block takes (G is grouped by these)
MAX_GROUP = 8
#: padded bytes of one K/V row the kernel takes (16-byte chunks on 32 lanes)
MAX_ROW_BYTES = 512
#: most table entries one split may span (its copy in shared memory)
MAX_SPLIT_PAGES = 1024
#: most blocks one sequence's positions are split over
MAX_SPLITS = 128
#: blocks the plan counts as resident on one SM (bf16 at D 128: its
#: ring takes most of the SM's shared memory)
BLOCKS_PER_SM = 1
#: a block's fixed cost (ring fill, state merge), and the cross-split merge
#: of the last block, in stage times
BLOCK_OVERHEAD_STAGES = 1
MERGE_STAGES = 1

#: kernel launches since the last :func:`reset_launches` (plain-version
#: calls are not counted)
LAUNCHES = {"paged_attention": 0, "paged_attention_state": 0}
#: calls on CUDA tensors that ``auto`` routed to the plain version, by reason
ROUTED_PLAIN = {"int8_kv": 0}

_COUNTERS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    ROUTED_PLAIN["int8_kv"] = 0


def _use_kernel(q: torch.Tensor, backend: str, scaled: bool) -> bool:
    if backend == "plain":
        return False
    if backend == "kernel":
        if scaled:
            raise ValueError("the paged-attention kernel gathers float pages "
                             "only; int8 KV scale pages take the 'plain' or "
                             "'auto' backend")
        if not q.is_cuda:
            raise KernelInputError("paged-attention backend 'kernel' needs "
                                   "CUDA tensors")
        return True
    if backend == "auto":
        if not q.is_cuda:
            return False
        if scaled:
            with _LOCK:
                ROUTED_PLAIN["int8_kv"] += 1
            return False
        return True
    raise ValueError(f"unknown paged-attention backend {backend!r}; "
                     f"expected one of {BACKENDS}")


@functools.lru_cache(maxsize=None)
def split_plan(sms: int, heads: int, table_rows: int, bs: int
               ) -> tuple[int, int]:
    """(n_split, rows_per_split) for ``heads`` (sequence, kv head, query
    group) walks over ``table_rows`` positions: at most :data:`MAX_SPLITS`
    splits of whole ring stages (:data:`STAGE_ROWS`) that cover every
    position exactly once, chosen to minimise (rounds of resident blocks) x
    (stages per block + a block's fixed cost) + the merge where there is
    more than one split, fewer splits on a tie.  Decided from shapes only; a
    split whose positions lie past a sequence's length exits at once."""
    if heads < 1 or table_rows < 1 or bs < 1:
        raise ValueError(f"no split plan for {heads} walks over "
                         f"{table_rows} positions (block size {bs})")
    stages = -(-table_rows // STAGE_ROWS)
    resident = BLOCKS_PER_SM * sms
    best = None
    for n in range(1, min(stages, MAX_SPLITS) + 1):
        per = -(-stages // n)
        if -(-stages // per) != n:
            continue            # the same split as a smaller n
        if -(-per * STAGE_ROWS // bs) + 1 > MAX_SPLIT_PAGES:
            continue
        cost = (-(-heads * n // resident) * (per + BLOCK_OVERHEAD_STAGES)
                + (MERGE_STAGES if n > 1 else 0))
        if best is None or cost < best[0]:
            best = (cost, n, per * STAGE_ROWS)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters, kept per device; the kernel leaves
    them zero again."""
    with _LOCK:
        cnt = _COUNTERS.get(dev)
        if cnt is None or cnt.numel() < n:
            cnt = torch.zeros(n, dtype=torch.int32, device=dev)
            _COUNTERS[dev] = cnt
    return cnt


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, k_scale_pages=None,
                    v_scale_pages=None, backend: str = "auto", mesh=None
                    ) -> torch.Tensor:
    """Paged decode attention.  q: (B, H, D); k_pages/v_pages: (N, bs, KH,
    D); block_tables: (B, P) page ids; lengths: (B,) last valid position
    (inclusive, any integer dtype).  Optional int8-KV scale pages (N, bs,
    KH).  ``mesh``: split the call over a mesh's shards (see the module's
    docstring).  Returns (B, H, D) in q.dtype."""
    scaled = k_scale_pages is not None or v_scale_pages is not None
    if mesh is not None and not scaled:
        return _paged_attention_sharded(q, k_pages, v_pages, block_tables,
                                        lengths, backend=backend, mesh=mesh)
    with op_analysis.kernel_call("paged_attention",
                                 flops=_flops(q, k_pages, block_tables)):
        return _paged_attention(q, k_pages, v_pages, block_tables, lengths,
                                k_scale_pages, v_scale_pages, backend)


def _flops(q, k_pages, block_tables) -> float:
    """4·B·H·(P·bs)·D: the scores and the weighted values over every
    position of the table (``op_analysis``)."""
    B, H, D = q.shape
    return 4.0 * B * H * block_tables.shape[-1] * k_pages.shape[1] * D


def _paged_attention(q, k_pages, v_pages, block_tables, lengths,
                     k_scale_pages, v_scale_pages, backend):
    scaled = k_scale_pages is not None or v_scale_pages is not None
    if not _use_kernel(q, backend, scaled):
        return ref.paged_attention_plain(
            q, k_pages, v_pages, block_tables, lengths,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
    out = torch.empty_like(q)
    _launch("paged_attention", q, k_pages, v_pages, block_tables, lengths,
            (out,))
    return out


def paged_attention_state(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *, backend: str = "auto"):
    """The state variant (K2s): the arguments of :func:`paged_attention`
    without scale pages; returns float32 (acc (B, KH, G, D) unnormalized,
    m (B, KH, G, 1), l (B, KH, G, 1)).  A row with no valid position (a
    negative length) gives exactly (0, -0.7 FLT_MAX, 0)."""
    with op_analysis.kernel_call("paged_attention_state",
                                 flops=_flops(q, k_pages, block_tables)):
        return _paged_attention_state(q, k_pages, v_pages, block_tables,
                                      lengths, backend)


def _paged_attention_state(q, k_pages, v_pages, block_tables, lengths,
                           backend):
    if not _use_kernel(q, backend, False):
        return ref.paged_attention_state_plain(q, k_pages, v_pages,
                                               block_tables, lengths)
    B, H, D = q.shape
    KH = k_pages.shape[2]
    G = H // KH
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KH, G, D), **f32)
    m = torch.empty((B, KH, G, 1), **f32)
    l = torch.empty((B, KH, G, 1), **f32)
    _launch("paged_attention_state", q, k_pages, v_pages, block_tables,
            lengths, (acc, m, l))
    return acc, m, l


def _launch(kind: str, q, k_pages, v_pages, block_tables, lengths,
            outs) -> None:
    """Check the inputs and launch ``kind`` (``paged_attention``: one
    output in q's dtype; ``paged_attention_state``: acc, m and l in
    float32) into ``outs``."""
    B, H, D = q.shape
    N, bs, KH, Dk = k_pages.shape
    P = block_tables.shape[-1]
    dev = q.device
    if (v_pages.shape != k_pages.shape or Dk != D or H % KH
            or block_tables.shape != (B, P) or lengths.shape != (B,)):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k_pages.shape)} "
            f"v {tuple(v_pages.shape)} tables {tuple(block_tables.shape)} "
            f"lengths {tuple(lengths.shape)}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes q and pages of one dtype, float32 "
                        f"or bfloat16; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if D * q.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"the kernel takes rows of at most {MAX_ROW_BYTES} "
                         f"bytes; head dim {D} in {q.dtype} is larger")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} lies on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel reads int32 tables and lengths (the engine's positions are
    # int64): a no-op when they already are
    tables = block_tables.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if B == 0:
        return
    G = H // KH
    n_groups = -(-G // MAX_GROUP)
    group = -(-G // n_groups)
    n_split, rows = split_plan(_sm_count(dev), B * KH * n_groups, P * bs, bs)
    part = cnt = None
    if n_split > 1:
        dp4 = -(-D // 4) * 4
        part = torch.empty(B * KH * n_groups * n_split * group * (dp4 + 2),
                           dtype=torch.float32, device=dev)
        cnt = _counters(dev, B * KH * n_groups)
    from repro_torch.kernels.paged_attention.build import library
    lib = library()
    fn = getattr(lib, f"{kind}_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k_pages.data_ptr()),
            ctypes.c_void_p(v_pages.data_ptr()),
            ctypes.c_void_p(tables.data_ptr()),
            ctypes.c_void_p(lens.data_ptr()),
            *(ctypes.c_void_p(t.data_ptr()) for t in outs),
            B, H, KH, D, bs, P, ctypes.c_float(D ** -0.5), code, n_groups,
            n_split, rows,
            ctypes.c_void_p(0 if part is None else part.data_ptr()),
            ctypes.c_void_p(0 if cnt is None else cnt.data_ptr()),
            ctypes.c_void_p(stream))
    if rc != 0:
        raise KernelError(f"{kind} kernel launch failed: CUDA error {rc}")
    with _LOCK:
        LAUNCHES[kind] += 1


def _paged_attention_sharded(q, k_pages, v_pages, block_tables, lengths, *,
                             backend: str, mesh) -> torch.Tensor:
    """The mesh split of :func:`paged_attention` (the reference's
    ``_paged_attention_sharded``): a batch cut over "data" and a table cut
    over "model" where each divides; with neither, one unsharded call."""
    from repro_torch.distributed import sharding
    axes = sharding.mesh_axes_dict(mesh)
    data, model = axes.get("data", 1), axes.get("model", 1)
    B = q.shape[0]
    bs = k_pages.shape[1]
    P = block_tables.shape[1]
    n_data = data if data > 1 and B % data == 0 else 1
    kv_split = model > 1 and P % model == 0
    rows, p_l = B // n_data, P // model
    lengths = torch.as_tensor(lengths, device=q.device)
    outs = []
    for i in range(n_data):
        sl = slice(i * rows, (i + 1) * rows)
        q_i, bt_i, ln_i = q[sl], block_tables[sl], lengths[sl]
        if not kv_split:
            dev = mesh.devices[i, 0]
            with op_analysis.on_shard((i, 0)):
                outs.append(paged_attention(
                    q_i.to(dev), k_pages, v_pages, bt_i.to(dev),
                    ln_i.to(dev), backend=backend).to(q.device))
            continue
        states = []
        for s in range(model):
            dev = mesh.devices[i, s]
            with op_analysis.on_shard((i, s)):
                acc, m, l = paged_attention_state(
                    q_i.to(dev), k_pages, v_pages,
                    bt_i[:, s * p_l:(s + 1) * p_l].to(dev),
                    (ln_i - s * p_l * bs).to(dev), backend=backend)
            states.append((acc.to(q.device), m.to(q.device),
                           l.to(q.device)))
        out = sharding.combine_softmax_state(*zip(*states))
        outs.append(out.reshape(q_i.shape).to(q.dtype))
    return outs[0] if n_data == 1 else torch.cat(outs)
