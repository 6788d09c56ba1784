"""Elastic mesh: keep decoding when slots die, without a restart.

Port of rtlsdr_ft8d_tpu/parallel/elastic.py. The reference tears the
daemon down on any device error (rtlsdr_ft8d.c:1224-1290); here a lost
device must not kill the band:

- HEARTBEAT: before a window (and after a failed decode) each living
  slot is probed under a timeout in a side thread, so a wedged device
  is marked dead instead of blocking the daemon.
- SHRINK: the ('host', 'chip') mesh is rebuilt from the largest
  power-of-two prefix of the living slots (8 -> 4 -> 2 -> 1).
- RESHARD: FT8 windows are stateless, so the next window's channels are
  simply sharded over the smaller mesh; channel counts that do not
  divide it are padded with zero channels, trimmed from the outputs.
- RETRY: a failed decode triggers a re-probe and, if the mesh changed,
  one retry of the same window on the shrunk mesh.

Slots may share a device (parallel/sharding.py), so `dead` holds slot
indices, and the heartbeat is asked per slot. Scope: one process
driving its local slots; recovery across the ranks of a process group
is not attempted (as in the JAX package, whose multi-controller case
needs a coordinated re-init).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..host.log import NO_TIMER
from ..pipeline import MAX_OSD, normalize_peak
from .dense import decode_window_dense
from .sharding import Mesh, local_devices, slot_device


def device_heartbeat(device, timeout: float = 5.0) -> bool:
    """True iff `device` completes a tiny put + fetch within `timeout` s,
    run in a daemon thread so a wedged device times out instead of
    blocking the caller."""
    result = {}

    def probe():
        try:
            x = torch.ones(8, device=device)
            result["ok"] = bool(x.cpu()[0] == 1.0)
        except Exception:         # a dead device may raise anything
            result["ok"] = False

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout)
    return result.get("ok", False)


class ElasticDecoder:
    """Dense-band decoding over a mesh of slots that shrinks when slots
    die: a decoder for pipeline.decode_window, called as
    WindowDecoder.forward is.

    `devices`: the slots (default one per visible card). `heartbeat(slot,
    timeout) -> bool` is asked per slot index; the default probes the
    slot's device with device_heartbeat, and tests and chaos drills
    inject their own. `decoder`, if given, is the WindowDecoder of its
    device, shared with the caller; the others are built once, at first
    use, and kept across meshes."""

    def __init__(self, devices=None, heartbeat=None,
                 heartbeat_timeout: float = 5.0, decoder=None):
        self.all_devices = [slot_device(d) for d in (
            devices if devices is not None else local_devices())]
        self.heartbeat = heartbeat or (lambda slot, timeout: device_heartbeat(
            self.all_devices[slot], timeout))
        self.heartbeat_timeout = heartbeat_timeout
        self.dead: set[int] = set()
        self.windows_recovered = 0        # observability: shrink events
        self._decoders = {} if decoder is None else {decoder.device: decoder}
        self.slots: list[int] = []
        self.mesh: Mesh | None = None
        self._rebuild()
        if self.check():                  # exclude already-dead slots
            self.windows_recovered = 0    # construction isn't a recovery

    # -- failure detection / mesh management --------------------------

    def alive_slots(self) -> list[int]:
        return [s for s in range(len(self.all_devices)) if s not in self.dead]

    def alive_devices(self) -> list[torch.device]:
        return [self.all_devices[s] for s in self.alive_slots()]

    def _rebuild(self) -> None:
        alive = self.alive_slots()
        if not alive:
            raise RuntimeError("elastic mesh: no devices left")
        n = 1
        while n * 2 <= len(alive):
            n *= 2
        self.slots = alive[:n]
        self.mesh = Mesh(np.asarray([self.all_devices[s] for s in self.slots],
                                    dtype=object).reshape(1, n),
                         ("host", "chip"), decoders=self._decoders)

    def check(self) -> bool:
        """Probe every living slot; shrink the mesh if any died. True iff
        the MESH changed: a dead spare outside the power-of-two prefix
        leaves it as it was, and a call must not spend its retry on the
        same mesh."""
        newly_dead = [s for s in self.alive_slots()
                      if not self.heartbeat(s, self.heartbeat_timeout)]
        if not newly_dead:
            return False
        old = list(self.slots)
        self.dead.update(newly_dead)
        self._rebuild()
        changed = self.slots != old
        if changed:
            self.windows_recovered += 1
        return changed

    # -- decoding ------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The first slot of the current mesh, where the outputs land."""
        return self.mesh.devices.flat[0]

    def __call__(self, i_samples, q_samples, *, budget=None, osd_cands=0,
                 ap_clamp_signs=None, ap_cw_signs=None, timer=NO_TIMER):
        """WindowDecoder.forward's contract over the current mesh: the
        (B, 48000) float32 I/Q peak-normalized as WindowDecoder.forward
        does, padded with zero channels to a multiple of the mesh size,
        decoded by decode_window_dense with the global budget `budget`
        (None or 0: all B * K) and min(B * osd_cands, MAX_OSD) deep-decode
        rows across the mesh, with one shrink-and-retry per failure that
        killed a slot. Returns the survivor dict as tensors on `device`,
        the channel-indexed fields trimmed to the B channels. `timer` is
        taken for the contract: the dense decode records no span of its
        own."""
        b = i_samples.shape[0]
        i_n, q_n = normalize_peak(torch.as_tensor(i_samples),
                                  torch.as_tensor(q_samples))
        last_err = None
        # heartbeat once per window, so that deaths between windows
        # shrink the mesh BEFORE the decode instead of failing it
        self.check()
        # at most one retry per remaining slot: each failed attempt must
        # kill at least one slot, or the error is re-raised
        for _attempt in range(len(self.all_devices) + 1):
            pad = (-b) % self.mesh.size
            try:
                out = decode_window_dense(
                    _padded(i_n, pad), _padded(q_n, pad), self.mesh, budget,
                    osd_cands_global=min(b * osd_cands, MAX_OSD),
                    ap_clamp_signs=ap_clamp_signs, ap_cw_signs=ap_cw_signs)
                # a failed card surfaces here, inside the retry, not at
                # the caller's download
                for dev in {d for d in self.mesh.devices.flat
                            if d.type == "cuda"}:
                    torch.cuda.synchronize(dev)
                # trim only CHANNEL-indexed outputs: the osd_* rows are
                # flat candidates, whose count can equal b + pad
                return {k: v if k.startswith("osd_") else v[:b]
                        for k, v in out.items()}
            except Exception as e:      # a device or collective failure
                last_err = e
                if not self.check():
                    raise               # nothing died: a real bug
        raise last_err


def _padded(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with `pad` zero channels appended."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
