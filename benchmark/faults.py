"""Faults planted under the timed path, for the readings that a limit of
`correct` is held against (readings.py --fault) and for the tests that
see a broken run come out not correct. Each takes `patch(obj, name,
value)`, such as pytest's monkeypatch.setattr or a Patcher, and breaks
the program through the module globals its entry calls.
"""


class Patcher:
    """patch(obj, name, value) that undo() reverts, last first."""

    def __init__(self):
        self._undo = []

    def __call__(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def _after_unpack(patch, edit):
    """Run edit(per-channel decode lists) on what the unpack produces."""
    from rtlsdr_ft8d_tpu_torch import pipeline

    orig = pipeline.unpack_survivors

    def broken(out, n_channels, hashes=None):
        results, sub = orig(out, n_channels, hashes)
        edit(results)
        return results, sub

    patch(pipeline, "unpack_survivors", broken)


def half_batch(patch):
    """The second half of the batch's decode lists left out."""
    def edit(results):
        for b in range(len(results) // 2, len(results)):
            results[b] = []

    _after_unpack(patch, edit)


def altered_answer(patch):
    """One decode's text altered where the unpack produces it."""
    from rtlsdr_ft8d_tpu_torch import pipeline

    def edit(results):
        for ds in results:
            if ds:
                d = ds[0]
                ds[0] = pipeline.Decode(
                    text="CQ ZZ9ZZZ AA00", freq_hz=d.freq_hz,
                    time_sec=d.time_sec, score=d.score, snr_db=d.snr_db)
                return

    _after_unpack(patch, edit)


def one_decode_moved(patch):
    """One decode a window moved by one tone (6.25 Hz) where the unpack
    produces it: its text stays right."""
    def edit(results):
        for ds in results:
            if ds:
                ds[0].freq_hz += 6.25
                return

    _after_unpack(patch, edit)


def state_unchanged(patch):
    """The channelizer returns its history unchanged after each chunk."""
    from rtlsdr_ft8d_tpu_torch.ops import channelize

    orig = channelize.StreamingChannelizerInt8.process

    def broken(self, i8, q8):
        hist = self._hist.clone()
        out = orig(self, i8, q8)
        self._hist = hist
        return out

    patch(channelize.StreamingChannelizerInt8, "process", broken)


def centre_shifted(patch):
    """Odd channels shifted to absolute frequency with the centre of the
    channel below: the wideband daemon's channel-centre step wrong for
    some channels."""
    from rtlsdr_ft8d_tpu_torch.host import daemon

    orig = daemon.channel_center_hz
    patch(daemon, "channel_center_hz",
          lambda k: orig(k - 1) if k % 2 else orig(k))


FAULTS = {f.__name__: f for f in (half_batch, altered_answer,
                                  one_decode_moved, state_unchanged,
                                  centre_shifted)}
