# Frozen copy of rtlsdr_ft8d_tpu_torch/protocol/pack.py:1-339, cut to
# the standard type-1/2 path (pack_callsign_28 without its hashed
# nonstandard calls, pack_grid_15, _try_pack_std, pack77's last step),
# which the benchmark's messages take; the benchmark keeps it unchanged
# so that a change to the program cannot move the yardstick.
# Copied from rtlsdr_ft8d_tpu/protocol/pack.py:1-338.
"""pack77: standard message text -> 77-bit FT8 payload.

Role-equivalent of ft8_lib's pack.c as used by the reference self-test
(rtlsdr_ft8d.c:927), for standard type-1/2 messages (CQ/DE/QRZ tokens,
standard callsigns, grids/reports); any other text is a PackError.
"""

import numpy as np

from .constants import FT8_PAYLOAD_BITS
from .text import A1, A2, A3, A4, MAX22, MAXGRID4, NTOKENS, normalize_standard


class PackError(ValueError):
    pass


def _bits_from_int(value: int, nbits: int):
    return [(value >> (nbits - 1 - i)) & 1 for i in range(nbits)]


def pack_callsign_28(call: str) -> int:
    call = call.strip().upper()
    if call == "DE":
        return 0
    if call == "QRZ":
        return 1
    if call == "CQ":
        return 2
    if call.startswith("CQ ") or call.startswith("CQ_"):
        tail = call[3:]
        if tail.isdigit() and len(tail) == 3:
            return 3 + int(tail)
        if tail.isalpha() and 1 <= len(tail) <= 4:
            m = 0
            for ch in tail:
                m = m * 27 + (ord(ch) - ord("A") + 1)
            return 1003 + m
        raise PackError(f"bad CQ token: {call!r}")
    std = normalize_standard(call)
    if std is not None:
        n = A1.index(std[0])
        n = n * 36 + A2.index(std[1])
        n = n * 10 + A3.index(std[2])
        n = n * 27 + A4.index(std[3])
        n = n * 27 + A4.index(std[4])
        n = n * 27 + A4.index(std[5])
        return NTOKENS + MAX22 + n
    raise PackError(f"not a packable callsign: {call!r}")


def pack_grid_15(field: str, *, allow_report=True):
    """Return (g15, ir) for the third message field ('' allowed)."""
    field = field.strip().upper()
    ir = 0
    if field.startswith("R "):
        ir = 1
        field = field[2:].strip()
    elif (len(field) >= 3 and field[0] == "R" and field[1] in "+-"
          and field[2:].isdigit()):
        ir = 1
        field = field[1:]
    if field == "":
        return MAXGRID4 + 1, ir
    if field == "RRR":
        return MAXGRID4 + 2, ir
    if field == "RR73":
        return MAXGRID4 + 3, ir
    if field == "73":
        return MAXGRID4 + 4, ir
    if (len(field) in (4, 6) and field[0] in "ABCDEFGHIJKLMNOPQR"
            and field[1] in "ABCDEFGHIJKLMNOPQR"
            and field[2].isdigit() and field[3].isdigit()):
        # 6-char locators are truncated to the 4-char square (golden vector
        # packs "FN20QI" as FN20, reference rtlsdr_ft8d.c:921)
        g = ((ord(field[0]) - 65) * 18 + (ord(field[1]) - 65)) * 100 \
            + int(field[2]) * 10 + int(field[3])
        return g, ir
    # isdigit (not lstrip) so a bare '+'/'-' is a PackError, not an
    # uncaught ValueError from int() (PackError subclasses ValueError,
    # so `except PackError` would NOT have caught it)
    if allow_report and field[0] in "+-" and field[1:].isdigit():
        report = int(field)
        if -30 <= report <= 99:
            return MAXGRID4 + 35 + report, ir
    raise PackError(f"bad grid/report field: {field!r}")


def _try_pack_std(tokens, i3):
    """Type 1 ('/R') or type 2 ('/P'): c28 r1 c28 r1 R1 g15 i3."""
    suffix = "/R" if i3 == 1 else "/P"
    # field splitting: [call_to] [call_de] [R] [grid/report]
    if len(tokens) < 2:
        return None
    ia = 0
    # 'CQ ddd' / 'CQ ABCD' consume two tokens for the first field
    field_a = tokens[0]
    rest = tokens[1:]
    if field_a == "CQ" and rest and (rest[0].isdigit() or
                                     (rest[0].isalpha() and len(rest) >= 2)):
        if rest[0].isdigit() and len(rest[0]) == 3:
            field_a = "CQ " + rest[0]
            rest = rest[1:]
        elif rest[0].isalpha() and len(rest[0]) <= 4 and len(rest) >= 2:
            field_a = "CQ " + rest[0]
            rest = rest[1:]
    if not rest:
        return None
    field_b = rest[0]
    rest = rest[1:]
    field_c = " ".join(rest)

    def strip_suffix(c):
        # len > 2: a bare '/R' token is not a suffixed call (same rule as
        # the C++ codec; a stripped-to-empty field used to hash '')
        if len(c) > 2 and c.endswith(suffix):
            return c[:-2], 1
        return c, 0

    ca, ipa = strip_suffix(field_a)
    cb, ipb = strip_suffix(field_b)
    try:
        n28a = pack_callsign_28(ca)
        n28b = pack_callsign_28(cb)
        g15, ir = pack_grid_15(field_c)
    except PackError:
        return None
    bits = (_bits_from_int(n28a, 28) + [ipa] + _bits_from_int(n28b, 28)
            + [ipb] + [ir] + _bits_from_int(g15, 15) + _bits_from_int(i3, 3))
    return np.array(bits, dtype=np.uint8)


def pack77(text: str) -> np.ndarray:
    """Pack standard message text into 77 payload bits; raises PackError
    on any other."""
    text = " ".join(text.strip().upper().split())
    tokens = text.split(" ")
    # scan ALL tokens: a '/P' call sits at tokens[2] after a two-token
    # directed CQ ('CQ EU K1ABC/P IO91' is type 2)
    i3 = 2 if any(t.endswith("/P") for t in tokens) else 1
    out = _try_pack_std(tokens, i3)
    if out is None:
        raise PackError(f"not a standard message: {text!r}")
    assert out.shape[0] == FT8_PAYLOAD_BITS
    return out
