"""The mesh of slots, and the channel-sharded decode.

Port of rtlsdr_ft8d_tpu/parallel/sharding.py. The JAX package shards the
channel axis of a batch over a device mesh and lets GSPMD partition
decode_window_device; its contract is the single-device forward's
output, field for field. Here a mesh is made of SLOTS: an ordered set of
places a shard runs, each naming a torch.device. Several slots may name
one device (eight CPU slots in the tests, four `cuda:0` slots on one
card), so the sharding logic runs the same on one card as on several;
slots on one device measure nothing about scaling across devices.

decode_window_sharded splits the B channels into equal row ranges, one
per slot, and runs each range on its slot's device with that device's
WindowDecoder. The two top-k selections that span channels (the global
budget and the deep decode's) run once, over the concatenated flat
scores on the first slot, in ops/sync.top_k's order (jax.lax.top_k's);
the selected indices go back to their shards, which run LLRs, BP, the AP
stages and the refinement on their own rows only.
"""

import numpy as np
import torch

from ..ops.sync import top_k
from ..pipeline import MAX_OSD, WindowDecoder, compact_survivors, \
    normalize_peak
from ..protocol.constants import K_MIN_SCORE

CHANNEL_AXIS = "ch"


def slot_device(device) -> torch.device:
    """A slot's device: torch.device(device), a bare "cuda" as the
    current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(backend: str = "cuda") -> list[torch.device]:
    """One slot per visible card of `backend`, or one CPU slot; "cuda"
    without a card raises: a mesh never falls back to the CPU."""
    if backend == "cpu":
        return [torch.device("cpu")]
    if backend != "cuda":
        raise ValueError(f"backend must be 'cuda' or 'cpu', got {backend!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card; "
                           "torch.cuda.is_available() is False")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An ndarray of slots with axis names, like jax.sharding.Mesh.

    In a process group (parallel/distributed.py) the mesh spans every
    rank's slots, rank-major: rank r holds the r-th of `world` equal
    blocks of the flat slot order, and only those are its own. The
    mesh keeps one WindowDecoder per device, built at first use
    (`decoder`); a caller may share that cache between meshes."""

    def __init__(self, devices, axis_names, rank: int = 0, world: int = 1,
                 decoders: dict | None = None):
        grid = np.asarray(devices, dtype=object)
        flat = np.empty(grid.size, dtype=object)
        flat[:] = [slot_device(d) for d in grid.reshape(-1)]
        self.devices = flat.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D slots, axis names "
                             f"{self.axis_names}")
        if world < 1 or not 0 <= rank < world or self.devices.size % world:
            raise ValueError(f"{self.devices.size} slots cannot be split "
                             f"over {world} ranks (rank {rank})")
        self.rank, self.world = rank, world
        self._decoders = {} if decoders is None else decoders

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def local_slots(self) -> list[tuple[int, torch.device]]:
        """(global slot index, device) of this rank's slots, in order."""
        per = self.size // self.world
        flat = self.devices.reshape(-1)
        return [(g, flat[g]) for g in range(self.rank * per,
                                             (self.rank + 1) * per)]

    def decoder(self, device) -> WindowDecoder:
        """The WindowDecoder on `device`, one per device."""
        dev = slot_device(device)
        if dev not in self._decoders:
            self._decoders[dev] = WindowDecoder().to(dev)
        return self._decoders[dev]


def make_mesh(num_devices: int | None = None,
              axis_name: str = CHANNEL_AXIS, devices=None) -> Mesh:
    """A 1-D mesh of `devices` (default: one slot per visible card), cut
    to its first `num_devices` slots."""
    devs = list(devices) if devices is not None else local_devices()
    if num_devices is not None:
        if num_devices > len(devs):
            raise ValueError(f"{num_devices} slots asked, {len(devs)} given")
        devs = devs[:num_devices]
    return Mesh(devs, (axis_name,))


def rows_on(x, start: int, stop: int, device) -> torch.Tensor:
    """Rows [start, stop) of a numpy array or tensor as float32 on
    `device` (no copy for a float32 tensor already there)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x[start:stop], np.float32))
        return x.to(device)
    return x[start:stop].to(device, torch.float32)


def on_device(x, device):
    """A replicated operand (None, numpy or tensor) on `device`."""
    if x is None:
        return None
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(device)


def split_flat(sel: torch.Tensor, chunk: int, n: int):
    """Flat indices into n equal shards of `chunk` each -> per shard
    (local indices, positions in `sel`), both in `sel`'s order."""
    shard = sel // chunk
    out = []
    for s in range(n):
        pos = torch.nonzero(shard == s).reshape(-1)
        out.append((sel[pos] - s * chunk, pos))
    return out


def concat_outputs(outs: list[dict], device) -> dict:
    """Per-shard output dicts -> one dict, each field concatenated along
    its first axis on `device`, in shard order."""
    return {k: torch.cat([o[k].to(device) for o in outs]) for k in outs[0]}


def decode_window_sharded(i_samples, q_samples, mesh: Mesh,
                          budget: int | None = None, osd_cands: int = 0,
                          ap_clamp_signs=None, ap_cw_signs=None) -> dict:
    """Decode (B, 48000) float32 I/Q channels sharded over the mesh.

    B must be a multiple of the mesh size. Takes the options of
    WindowDecoder.forward and returns its dict, on the first slot's
    device: the same values, field for field."""
    if mesh.world != 1:
        raise ValueError("decode_window_sharded runs in one process; "
                         "parallel/dense.py spans a process group")
    slots = [dev for _, dev in mesh.local_slots()]
    n = len(slots)
    B = i_samples.shape[0]
    if B % n:
        raise ValueError(f"{B} channels do not divide over {n} slots")
    b_loc = B // n
    head = slots[0]
    shards = []
    for s, dev in enumerate(slots):
        dec = mesh.decoder(dev)
        i_n, q_n = normalize_peak(
            rows_on(i_samples, s * b_loc, (s + 1) * b_loc, dev),
            rows_on(q_samples, s * b_loc, (s + 1) * b_loc, dev))
        wf = dec._waterfall(i_n, q_n)
        clamp = on_device(ap_clamp_signs, dev)
        shards.append({"dec": dec, "wf": wf, "samples": (i_n, q_n),
                       "cand": dec.candidates(wf),
                       "ap_rows": [] if clamp is None else list(clamp),
                       "cw": on_device(ap_cw_signs, dev)})
    K = shards[0]["cand"]["score"].shape[-1]

    def global_top_k(flat_of, k):
        """top_k over the shards' concatenated flat rankings, split back
        into (local indices on the shard's device, positions)."""
        ranks = torch.cat([flat_of(sh).to(head) for sh in shards])
        _, sel = top_k(ranks, k)
        return [(local.to(sh["dec"].device), pos) for sh, (local, pos) in
                zip(shards, split_flat(sel, b_loc * K, n))]

    sels = [None] * n
    if budget and budget < B * K:
        sels = [local for local, _ in global_top_k(
            lambda sh: sh["cand"]["score"].reshape(-1), budget)]
    for sh, sel in zip(shards, sels):
        sh["hard"], sh["errors"], sh["ok"] = sh["dec"].main_pass(
            sh["wf"], sh["cand"], sel, sh["ap_rows"], sh["cw"])

    osd = None
    if osd_cands > 0:
        for sh in shards:
            sh["rank"], sh["failed"] = WindowDecoder.osd_rank(
                sh["cand"], sh["errors"], sh["cand"]["score"] >= K_MIN_SCORE)
        n_osd = min(B * osd_cands, MAX_OSD, B * K)
        picks = global_top_k(lambda sh: sh["rank"], n_osd)
        osd = {}
        for s, (sh, (local, pos)) in enumerate(zip(shards, picks)):
            sh["hard"], sh["errors"], sh["ok"], fields = \
                sh["dec"].deep_pass(sh["samples"], sh["wf"], sh["cand"],
                                    sh["hard"], sh["errors"], sh["ok"],
                                    sh["failed"], local, sh["ap_rows"],
                                    sh["cw"])
            fields["osd_chan"] = fields["osd_chan"] + s * b_loc
            # the global selection's order
            for k, v in fields.items():
                if k not in osd:
                    osd[k] = v.new_empty((n_osd,) + v.shape[1:],
                                         device=head)
                osd[k][pos] = v.to(head)
    out = concat_outputs([compact_survivors(
        sh["wf"], sh["cand"], sh["hard"], sh["errors"], sh["ok"],
        sh["dec"].bit_weights) for sh in shards], head)
    if osd is not None:
        out.update(osd)
    return out
