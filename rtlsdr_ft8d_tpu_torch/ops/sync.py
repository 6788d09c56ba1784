"""Costas sync scores over the waterfall and the top-K candidate search.

Port of rtlsdr_ft8d_tpu/ops/sync.py (sync_scores, the plain version here;
find_sync) and ops/sync_pallas.py (the kernel, csrc/sync.cu, which also
runs find_sync's first top-K stage on the card). Scores are integer math,
bit-identical to the C loop; the top-K keeps the order of jax.lax.top_k
(lower index first among equal scores) on every device.
"""

import torch
import torch.nn.functional as F

from ..protocol.constants import COSTAS_PATTERN, K_MAX_CANDIDATES, NUM_BIN
from . import build
from .tables import NUM_TIME_OFFSETS, TIME_OFFSET_MIN

NUM_FREQ_OFFSETS = NUM_BIN - 7                           # 249
CHUNK = 16     # freq-offset cells per first-stage chunk (100 Hz of band)
CHUNK_K = 4    # survivors per chunk
_PAD_SCORE = -(1 << 20)
PAD_WIDTH = NUM_FREQ_OFFSETS + (-NUM_FREQ_OFFSETS) % CHUNK    # 256
# first-stage survivors per batch row: 4 planes x 36 rows x 16 chunks x 4
NUM_SURVIVORS = 4 * NUM_TIME_OFFSETS * (PAD_WIDTH // CHUNK) * CHUNK_K

KERNEL = build.Kernel(
    "sync", "ft8_sync", [build.P] * 5 + [build.I],
    source="rtlsdr_ft8d_tpu_torch/csrc/sync.cu",
    replaces="rtlsdr_ft8d_tpu/ops/sync_pallas.py:65")


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of integer `x` along
    the last dim, in jax.lax.top_k's order: descending, and the lower
    index first among equal values. torch.topk promises no order among
    ties, so it runs on the unique int64 key value * L + (L - 1 - index)."""
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    key = x.to(torch.int64) * n + rev
    idx = torch.topk(key, k, dim=-1, sorted=True).indices
    return x.gather(-1, idx), idx


def sync_scores_plain(wf: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """(..., 92, 2, 2, 256) uint8 -> (..., 2, 2, 36, 249) int32 by the
    difference-plane algebra of rtlsdr_ft8d_tpu/ops/sync.py:87-121."""
    w = wf.to(torch.int32).movedim(-4, -2)           # (..., 2, 2, 92, 256)
    dl = F.pad(w[..., :, 1:] - w[..., :, :-1], (1, 0))
    dh = F.pad(w[..., :, :-1] - w[..., :, 1:], (0, 1))
    dp = F.pad(w[..., 1:, :] - w[..., :-1, :], (0, 0, 1, 0))
    dn = F.pad(w[..., :-1, :] - w[..., 1:, :], (0, 0, 0, 1))
    s4 = dl + dh + dp + dn
    variants = {"all": s4, "no_dp": s4 - dp,         # k == 0
                "no_dl": s4 - dl,                    # k == 3 (sm == 0)
                "no_dn": s4 - dn}                    # k == 6

    def fold(e):
        # rows to + m + k for m in {0, 36, 72}; zero rows outside the window
        ep = F.pad(e, (0, 0, 12, 10))
        return ep[..., 0:42, :] + ep[..., 36:78, :] + ep[..., 72:114, :]

    folded = {v: fold(e) for v, e in variants.items()}
    score = None
    for k in range(7):
        sm = int(COSTAS_PATTERN[k])
        v = {0: "no_dp", 3: "no_dl", 6: "no_dn"}.get(k, "all")
        term = folded[v][..., k:k + NUM_TIME_OFFSETS,
                         sm:sm + NUM_FREQ_OFFSETS]
        score = term if score is None else score + term
    # C division truncates toward zero; a bare // floors
    cnt = count.to(torch.int32)[:, None]
    return torch.sign(score) * torch.div(score.abs(), cnt,
                                         rounding_mode="floor")


def _sync_cuda(wf: torch.Tensor, count: torch.Tensor, survivors: bool):
    """One launch of csrc/sync.cu on (..., 92, 2, 2, 256) uint8 `wf`: the
    score grid, as a 1-tuple; or with `survivors` the first stage's
    (v1, gidx) without the grid."""
    dev = wf.device
    batch_shape = wf.shape[:-4]
    w = wf.reshape((-1,) + tuple(wf.shape[-4:])).contiguous()
    if w.data_ptr() % 16:                 # the kernel stages 16-byte rows
        w = w.clone()
    B = w.shape[0]
    if survivors:
        outs = [torch.empty((B, NUM_SURVIVORS), dtype=torch.int32,
                            device=dev) for _ in range(2)]
        ptrs = [None] + [build.check(t, torch.int32) for t in outs]
    else:
        outs = [torch.empty((B, 2, 2, NUM_TIME_OFFSETS, NUM_FREQ_OFFSETS),
                            dtype=torch.int32, device=dev)]
        ptrs = [build.check(outs[0], torch.int32), None, None]
    if B:
        KERNEL(dev, build.check(w, torch.uint8, (B, 92, 2, 2, NUM_BIN), dev),
               build.check(count, torch.int32, (NUM_TIME_OFFSETS,), dev),
               *ptrs, B)
    return tuple(t.reshape(batch_shape + t.shape[1:]) for t in outs)


def sync_scores_cuda(wf: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The kernel's scores-only mode."""
    return _sync_cuda(wf, count, survivors=False)[0]


def sync_scores(wf: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    fn = sync_scores_cuda if build.on_cuda(wf) else sync_scores_plain
    return fn(wf, count)


def chunk_survivors(scores: torch.Tensor):
    """find_sync's first stage (rtlsdr_ft8d_tpu/ops/sync.py:163-176) on a
    (..., 2, 2, 36, 249) score grid: every row padded to PAD_WIDTH with
    _PAD_SCORE, the top CHUNK_K of each CHUNK-cell chunk in top_k's order.
    Returns (v1, gidx), (..., NUM_SURVIVORS) int32 each: the scores, and
    their indices in the padded (2, 2, 36, PAD_WIDTH) grid."""
    batch_shape = scores.shape[:-4]
    sp = F.pad(scores, (0, PAD_WIDTH - NUM_FREQ_OFFSETS), value=_PAD_SCORE)
    chunks = sp.reshape(batch_shape + (-1, CHUNK))
    v1, i1 = top_k(chunks, CHUNK_K)
    base = (torch.arange(chunks.shape[-2], device=scores.device)
            * CHUNK)[:, None]
    return (v1.reshape(batch_shape + (-1,)),
            (i1 + base).reshape(batch_shape + (-1,)).to(torch.int32))


def sync_survivors_cuda(wf: torch.Tensor, count: torch.Tensor):
    """The kernel's fused mode: chunk_survivors(sync_scores(wf)) without
    the score grid."""
    return _sync_cuda(wf, count, survivors=True)


def sync_survivors(wf: torch.Tensor, count: torch.Tensor):
    if build.on_cuda(wf):
        return sync_survivors_cuda(wf, count)
    return chunk_survivors(sync_scores_plain(wf, count))


def find_sync(wf: torch.Tensor, count: torch.Tensor,
              num_candidates: int = K_MAX_CANDIDATES, exact: bool = False):
    """Top-K candidates by sync score (rtlsdr_ft8d_tpu/ops/sync.py:140-186).

    Returns a dict of (..., K) int64 tensors: score, time_sub, freq_sub,
    time_offset, freq_offset. By default the top-K runs in two stages
    (sync_survivors: top-CHUNK_K per 16-cell chunk of a row padded to
    whole chunks, fused into the score kernel on the card; then the
    global top-K over the survivors); `exact=True` sorts every cell.
    """
    if exact:
        scores = sync_scores(wf, count)
        sp = F.pad(scores, (0, PAD_WIDTH - NUM_FREQ_OFFSETS),
                   value=_PAD_SCORE)
        top, idx = top_k(sp.reshape(scores.shape[:-4] + (-1,)),
                         num_candidates)
    else:
        v1, gidx = sync_survivors(wf, count)
        top, sel = top_k(v1, num_candidates)
        idx = gidx.gather(-1, sel).to(torch.int64)
    # unravel [ts][fs][to][fo] (fo over the padded row width)
    fo = idx % PAD_WIDTH
    rest = idx // PAD_WIDTH
    to = rest % NUM_TIME_OFFSETS + TIME_OFFSET_MIN
    rest = rest // NUM_TIME_OFFSETS
    return {"score": top.to(torch.int64), "time_sub": rest // 2,
            "freq_sub": rest % 2, "time_offset": to, "freq_offset": fo}
