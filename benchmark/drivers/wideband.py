"""The --wideband daemon, driven as run_daemon's loop drives it
(rtlsdr_ft8d_tpu_torch/host/daemon.py:448-477): the native ring is
popped into WindowProcessor.pop_buffers, then process_fullrate
channelizes the capture, decodes the selected channels from the bank on
the backend, shifts them to absolute frequencies, deduplicates and emits
(reporter off, spots to a file under TMPDIR). A timed window runs from
the start of the ring pop to the deduplicated decode list. Before it,
untimed, the hand-over pushes the whole capture into the ring, as the
synthetic daemon's `source` stage does: a backlog of one ready window,
and no push beside the pop.
"""

import contextlib
import ctypes
import dataclasses
import tempfile
import time

import numpy as np
import torch

import registry
from peaks import bp_work, llr_work, snr_work, sync_work, waterfall_work
from reference import channelizer as ref_ch, compare, decoder as ref_decoder

SURVIVORS = 50
RING_SAMPLES = 1 << 26          # run_daemon's ring: one window fits


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 spans):
        from rtlsdr_ft8d_tpu_torch import native
        from rtlsdr_ft8d_tpu_torch.host import cli, daemon
        from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder

        self.spans, self.device = spans, device
        argv = list(cfg["argv"]) + ["--backend", device]
        self.args = cli.build_parser().parse_args(argv)
        dial, _ = cli.parse_frequency(self.args.frequency[0],
                                      self.args.directsampling)
        self.window = daemon.FULLRATE_WINDOW
        self.sel = daemon.wideband_channels(self.args.wideband_channels)
        self.channels = len(self.sel)
        self.budget = self.args.budget
        if self.budget is None and self.channels >= 512:
            self.budget = int(cfg["budget"])
        self.lib = native.load()
        if self.lib is None:
            raise RuntimeError("the port's native ring is unavailable")
        gen = registry.generator(traffic["generator"])
        self.data = gen.generate(traffic, seed, device)
        self.captures = self.data["captures"]
        self.decoder = WindowDecoder().to(device)
        self._daemon = daemon
        self.proc = daemon.WindowProcessor(self.args, dial, self.decoder)
        self.i8 = np.zeros(self.window, dtype=np.int8)
        self.q8 = np.zeros(self.window, dtype=np.int8)
        self.log = tempfile.TemporaryFile("w+")
        self._patch()
        self.ring = self.lib.ingest_ring_create(RING_SAMPLES)
        self.n = 0
        self.banks = {}             # input index -> (window, its bank)

    def _patch(self):
        """Host ranges around the channelizer and the decode, and the
        bank each channelize call hands on."""
        ch = self.proc.channelizer
        orig_process = ch.process
        orig_decode = self._daemon.decode_window

        def process(i8, q8):
            with self.spans.range("channelize"):
                out = orig_process(i8, q8)
            self._bank = out
            return out

        def decode_window(*a, **k):
            with self.spans.range("decode"):
                return orig_decode(*a, **k)

        ch.process = process
        self._daemon.decode_window = decode_window
        self._restore = lambda: setattr(self._daemon, "decode_window",
                                        orig_decode)

    def ready(self) -> float:
        """The hand-over, untimed: push the next window's capture whole
        into the empty ring; returns the seconds it took."""
        t0 = time.perf_counter()
        buf = self.captures[self.n % len(self.captures)]
        self.lib.ingest_ring_push_u8(
            self.ring, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.window)
        return time.perf_counter() - t0

    def step(self):
        """One timed window; returns (its input's index, [the
        deduplicated decode list])."""
        from rtlsdr_ft8d_tpu_torch.host.log import StageTimer

        r = self.n % len(self.captures)
        timer = StageTimer()
        self.proc.timer = timer
        ptr = ctypes.POINTER(ctypes.c_int8)
        with contextlib.redirect_stdout(self.log):
            with self.spans.span("pop"):
                pop_i, pop_q = self.proc.pop_buffers(self.i8, self.q8)
                got = self.lib.ingest_ring_pop(
                    self.ring, pop_i.ctypes.data_as(ptr),
                    pop_q.ctypes.data_as(ptr), self.window)
            if got < self.window:
                raise RuntimeError(f"short window: {got} samples")
            decodes = self.proc.process_fullrate(pop_i, pop_q)
        for name, ms in timer.timings.items():
            self.spans.add(f"stage.{name}", ms)
        self.banks[r] = (self.n, self._bank)
        self._bank = None
        self.n += 1
        return r, [decodes]

    def close(self):
        """Free the ring and the program's state."""
        self.lib.ingest_ring_destroy(self.ring)
        self._restore()
        self.log.close()
        self.proc = self.decoder = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _history_and_window(self, r: int):
        """Input r's int8 I/Q as the channelizer sees it: the last
        HISTORY samples of the capture before it, then its own."""
        dev = self.device
        cur = ref_ch.ingest_u8(torch.from_numpy(self.captures[r]).to(dev))
        # the window is a multiple of 4 samples, so every capture starts
        # at mixer phase 0, and its last HISTORY samples at phase -HISTORY
        prev = ref_ch.ingest_u8(torch.from_numpy(
            self.captures[(r - 1) % len(self.captures)][-2 * ref_ch.HISTORY:]
        ).to(dev), phase=-ref_ch.HISTORY % 4)
        return tuple(torch.cat([p, c]) for p, c in zip(prev, cur))

    def _reference_input(self, r: int, mode: str):
        """Input r through the plain reference: (its bank (i, q) of the
        selected channels, [the deduplicated decode list], the BP work),
        the channelizer in `mode` ("f64", or "tf32" for the control) and
        the decode in float32 or, for the control, TF32."""
        i8, q8 = self._history_and_window(r)
        bank = ref_ch.channelize(i8, q8, 0, self.sel, mode)
        del i8, q8
        lists, work = ref_decoder.decode_window(
            *bank, budget=self.budget,
            mode="tf32" if mode == "tf32" else "f32")
        per_channel = []
        for k, ds in zip(self.sel, lists):
            c = ref_ch.channel_center_hz(k)
            per_channel.append((k, [dataclasses.replace(
                d, freq_hz=d.freq_hz + c) for d in ds]))
        return bank, [ref_ch.dedup_wideband(per_channel)], work

    def reference(self) -> list[dict]:
        """Per input: {"lists": [the deduplicated decode list],
        "bank_rel_err": of the program's latest bank of that input (None
        if none was kept after the first window), "bp_iterations",
        "bp_rows"}. The program's banks are freed as they are compared."""
        out = []
        for r in range(len(self.captures)):
            bank, lists, work = self._reference_input(r, "f64")
            err = None
            kept = self.banks.pop(r, None)
            if kept is not None and kept[0] > 0:
                idx = torch.as_tensor(self.sel, device=kept[1][0].device)
                err = compare.bank_rel_err(kept[1][0].index_select(0, idx),
                                           kept[1][1].index_select(0, idx),
                                           *bank)
            del kept, bank
            out.append({"lists": lists, "bank_rel_err": err, **work})
        return out

    def control(self, ref: list[dict]) -> dict:
        """The numbers compared with the reference in the program's
        place, computed in TF32: its decode lists of each input and its
        banks' distance from the float64 ones."""
        outputs, errs = [], []
        for r in range(len(self.captures)):
            bank_c, lists, _ = self._reference_input(r, "tf32")
            i8, q8 = self._history_and_window(r)
            bank = ref_ch.channelize(i8, q8, 0, self.sel, "f64")
            errs.append(compare.bank_rel_err(*bank_c, *bank))
            del bank, bank_c, i8, q8
            outputs.append((r, lists))
        nums = self.checks(ref, outputs)
        nums["bank_rel_err"] = max(errs)
        return nums

    def checks(self, ref: list[dict], outputs) -> dict:
        """The numbers compared over `outputs`, (input index,
        [deduplicated list]) pairs of windows after the first (whose
        history is the channelizer's zeros), and the banks kept."""
        nums = compare.decode_numbers(
            (prog, ref[r]["lists"], [self.data["truth"][r]])
            for r, prog in outputs)
        errs = [x["bank_rel_err"] for x in ref
                if x.get("bank_rel_err") is not None]
        if errs:
            nums["bank_rel_err"] = max(errs)
        return nums

    def work(self, r: int, ref: list[dict]) -> dict:
        rows = ref[r]["bp_rows"]
        return {"waterfall": [waterfall_work(self.channels)],
                "sync": [sync_work(self.channels)],
                "llr": [llr_work(rows), snr_work(self.channels * SURVIVORS)],
                "bp": [bp_work(rows, ref[r]["bp_iterations"])]}

    def window_record(self) -> dict:
        parts = {}
        for name, vals in self.spans.items():
            if name.startswith("stage."):
                parts[name[6:]] = sum(vals) / len(vals)
        return {"windows": self.n, "mean_ms_by_part": parts,
                "peak_counts": self.data["peak_counts"],
                "ring_dropped": int(self.lib.ingest_ring_dropped(self.ring))}
