"""The multiband decode: C baseband channels decoded as one batch per
window, the call run_daemon's multiband branch makes
(rtlsdr_ft8d_tpu_torch/host/daemon.py:498-503): decode_window on (i, q)
host float32, one CallsignHashTable per channel kept across windows,
return_stats=True, one WindowDecoder. A timed window is that call, from
the hand-over of the host arrays to the per-channel decode lists.
"""

import numpy as np
import torch

import registry
from reference import compare, decoder as ref_decoder
from peaks import bp_work, llr_work, snr_work, sync_work, waterfall_work

SURVIVORS = 50          # the forward compacts 50 candidates a channel
STAT_KEYS = ("candidates_above_min", "ldpc_converged", "crc_passed",
             "messages_unique")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 spans):
        from rtlsdr_ft8d_tpu_torch import pipeline
        from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable

        self.spans, self.device = spans, device
        self.channels = int(cfg["channels"])
        self.budget = cfg.get("budget")
        gen = registry.generator(traffic["generator"])
        self.data = gen.generate(traffic, seed, device, channels=self.channels)
        self.windows = self.data["windows"]
        self._pipeline = pipeline
        self.decoder = pipeline.WindowDecoder().to(device)
        self.hashes = [CallsignHashTable() for _ in range(self.channels)]
        self.n = 0
        self.totals = dict.fromkeys(STAT_KEYS, 0)   # WindowStats, summed

    def ready(self) -> float:
        """Seconds the next window waited for its hand-over: none, the
        windows are ready on the host."""
        return 0.0

    def step(self):
        """One timed window; returns (its input's index, the per-channel
        decode lists)."""
        r = self.n % len(self.windows)
        with self.spans.span("decode"):
            results, stats = self._pipeline.decode_window(
                self.windows[r], hashes=self.hashes, budget=self.budget,
                return_stats=True, decoder=self.decoder)
        self.n += 1
        for k in STAT_KEYS:
            self.totals[k] += getattr(stats, k)
        return r, results

    def close(self):
        """Free the program's state on the device."""
        self.decoder = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def reference(self, mode: str = "f32") -> list[dict]:
        """Per input: {"lists": the reference's per-channel decode lists,
        "bp_iterations", "bp_rows"}, the matmuls at `mode`'s precision."""
        out = []
        for i, q in self.windows:
            t = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                 for x in (i, q)]
            lists, work = ref_decoder.decode_window(*t, budget=self.budget,
                                                    mode=mode)
            out.append({"lists": lists, **work})
        return out

    def control(self, ref: list[dict]) -> dict:
        """The numbers compared with the reference in the program's
        place, computed in TF32."""
        ctl = self.reference("tf32")
        return self.checks(ref, [(r, c["lists"]) for r, c in enumerate(ctl)])

    def checks(self, ref: list[dict], outputs) -> dict:
        """The numbers compared over `outputs`, (input index, per-channel
        decode lists) pairs."""
        return compare.decode_numbers(
            (prog, ref[r]["lists"], self.data["truth"][r])
            for r, prog in outputs)

    def work(self, r: int, ref: list[dict]) -> dict:
        """(bytes, operations) of each kernel launch of a window of input
        r: the waterfall and sync over C channels, the LLR launch on the
        BP rows and the survivors' SNR launch, BP on its rows."""
        rows = ref[r]["bp_rows"]
        return {"waterfall": [waterfall_work(self.channels)],
                "sync": [sync_work(self.channels)],
                "llr": [llr_work(rows), snr_work(self.channels * SURVIVORS)],
                "bp": [bp_work(rows, ref[r]["bp_iterations"])]}

    def window_record(self) -> dict:
        """What is no metric: the program's WindowStats per window, over
        every window run."""
        return {"windows": self.n,
                "stats_per_window": {k: v / max(self.n, 1)
                                     for k, v in self.totals.items()}}
