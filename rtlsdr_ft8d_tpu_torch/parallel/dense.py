"""Dense-band decode with a GLOBAL candidate budget over a mesh of slots.

Port of rtlsdr_ft8d_tpu/parallel/dense.py. When thousands of channels are
sharded over a ('host', 'chip') mesh, the window's LDPC budget goes to
the globally strongest candidates, not to a fixed quota per channel.
Phase A on every slot: waterfall and find_sync. Then one gather of
every slot's (b_loc * K,) int32 scores (concatenated in slot order,
then all-gathered between the ranks of a process group) and one
threshold: the global_budget-th score, at least K_MIN_SCORE; a candidate
is selected when its score reaches it, so every tie at the threshold is
in. Phase B on every slot: LLRs of every candidate, zeroed outside the
selection, BP on all of them (the unselected rows are all zero: errors
83, hard bits 0), CRC, the clamp rows and the bank masked by the
selection, the deep decode per shard, compaction. Outputs are
concatenated in slot order, row-major over (host, chip).

The samples are taken as given: the caller normalizes them
(parallel/elastic.ElasticDecoder does, as
rtlsdr_ft8d_tpu/host/daemon.py:264-268).
"""

import numpy as np
import torch

from ..ops.llr import extract_llrs
from ..ops.sync import top_k
from ..pipeline import compact_survivors
from ..protocol.constants import FT8_LDPC_M, K_MAX_CANDIDATES, K_MIN_SCORE
from .distributed import Shard, all_gather_rows
from .sharding import Mesh, concat_outputs, local_devices, on_device, rows_on


def make_grid_mesh(hosts: int, chips: int, devices=None) -> Mesh:
    """('host', 'chip') mesh of the first hosts * chips of `devices`
    (default: one slot per visible card); channels shard over both
    axes."""
    devs = list(devices) if devices is not None else local_devices()
    if len(devs) < hosts * chips:
        raise ValueError(f"a {hosts} x {chips} mesh needs {hosts * chips} "
                         f"slots, {len(devs)} given")
    return Mesh(np.asarray(devs[:hosts * chips], dtype=object)
                .reshape(hosts, chips), ("host", "chip"))


def decode_window_dense(i_samples, q_samples, mesh: Mesh,
                        global_budget: int | None,
                        osd_cands_global: int = 0,
                        ap_clamp_signs=None, ap_cw_signs=None):
    """Decode channels sharded over the mesh with a GLOBAL budget.

    Args:
      i_samples, q_samples: (B, 48000) float32 (numpy or tensors), B a
        multiple of the mesh size; in a process group, each rank's own
        rows as distributed.shard_channels gives them.
      global_budget: candidates across all channels that get BP this
        window; 0 or None means all B * K.
      osd_cands_global: deep-decode retries across the mesh, split evenly
        over the slots; each refines its own best BP failures from its
        own samples.
      ap_clamp_signs (H, 77) / ap_cw_signs (H, 174): the clamp rows and
        the codeword bank (ops/ap.py), replicated to every slot.

    Returns the compacted per-channel dict of WindowDecoder.forward plus
    'n_selected' (B,) int32, and the osd_* fields (channel indices
    global) when osd_cands_global > 0: tensors on the first slot's
    device, or in a process group this rank's rows as
    distributed.Shard, for pipeline.unpack_survivors and
    pipeline._merge_osd_decodes.
    """
    sharded = isinstance(i_samples, Shard)
    i_loc = i_samples.data if sharded else i_samples
    q_loc = q_samples.data if sharded else q_samples
    B = i_samples.shape[0]
    if not global_budget:
        global_budget = B * K_MAX_CANDIDATES
    slots = mesh.local_slots()
    n_shards = mesh.size
    if B % n_shards or i_loc.shape[0] != B // n_shards * len(slots):
        raise ValueError(f"{B} channels ({i_loc.shape[0]} on this rank) do "
                         f"not divide over {n_shards} slots")
    b_loc = B // n_shards
    n_osd_loc = max(osd_cands_global // n_shards, 0)
    head = slots[0][1]

    # phase A: waterfall and candidates on every slot
    shards = []
    for j, (g, dev) in enumerate(slots):
        dec = mesh.decoder(dev)
        i_s = rows_on(i_loc, j * b_loc, (j + 1) * b_loc, dev)
        q_s = rows_on(q_loc, j * b_loc, (j + 1) * b_loc, dev)
        wf = dec._waterfall(i_s, q_s)
        shards.append((g, dec, (i_s, q_s), wf,
                       dec.candidates(wf)))

    # one gather of the scores, one global threshold
    gathered = torch.cat([cand["score"].reshape(-1).to(head, torch.int32)
                          for *_, cand in shards])
    if mesh.world > 1:
        gathered = all_gather_rows(gathered)
    k = min(global_budget, gathered.shape[0])
    # only the k-th value counts, so the order among ties does not
    kth = torch.topk(gathered, k, sorted=True).values[-1]
    thresh = torch.clamp(kth, min=K_MIN_SCORE)

    # phase B
    outs = []
    for g, dec, samples, wf, cand in shards:
        dev = dec.device
        scores = cand["score"]
        selected = scores >= thresh.to(dev)
        clamp = on_device(ap_clamp_signs, dev)
        ap_rows = [] if clamp is None else list(clamp)
        cw = on_device(ap_cw_signs, dev)
        llrs = torch.where(selected[..., None], extract_llrs(wf, cand), 0.0)
        hard, errors, ok = dec._main_and_ap(llrs, scores, ap_rows, cw,
                                            eligible=selected)
        errors = torch.where(selected, errors, FT8_LDPC_M)
        osd = {}
        if n_osd_loc > 0:
            flat_rank, failed = dec.osd_rank(cand, errors, selected)
            _, sel_f = top_k(flat_rank, min(n_osd_loc, flat_rank.shape[0]))
            hard, errors, ok, osd = dec.deep_pass(
                samples, wf, cand, hard, errors, ok, failed, sel_f, ap_rows,
                cw)
            osd["osd_chan"] = osd["osd_chan"] + g * b_loc   # global index
        out = compact_survivors(wf, cand, hard, errors, ok, dec.bit_weights)
        out["n_selected"] = selected.to(torch.int32).sum(-1)
        out.update(osd)
        outs.append(out)
    out = concat_outputs(outs, head)
    if mesh.world == 1:
        return out
    # this rank's block of every output: its channels, and its slots'
    # osd rows
    return {k: Shard(v, mesh.rank * v.shape[0], mesh.world * v.shape[0])
            for k, v in out.items()}
