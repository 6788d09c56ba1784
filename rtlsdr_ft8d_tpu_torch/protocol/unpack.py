# Copied from rtlsdr_ft8d_tpu/protocol/unpack.py:1-255; the batch unpack
# below unpack_spot is the port's own.
"""unpack77: 77-bit FT8 payload -> message text.

Role-equivalent of ft8_lib's unpack.c; the reference consumes the unpacked
text at rtlsdr_ft8d.c:1494,1509. Supports i3 types 0 (free
text / telemetry), 1, 2 (standard, '/R' and '/P'), 3 (RTTY RU), 4
(nonstandard call) and reports unknown types as raw hex.
"""

import numpy as np

from .text import (A1, A2, A3, A4, FREE_TEXT_ALPHABET, HASH_ALPHABET, MAX22,
                   MAXGRID4, NTOKENS, CallsignHashTable)


class UnpackError(ValueError):
    pass


def _int_from_bits(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def unpack_callsign_28(n28: int, ip: int, i3: int,
                       hashes: CallsignHashTable | None = None) -> str:
    if n28 < NTOKENS:
        if n28 == 0:
            return "DE"
        if n28 == 1:
            return "QRZ"
        if n28 == 2:
            return "CQ"
        if 3 <= n28 <= 1002:
            return f"CQ {n28 - 3:03d}"
        if 1003 <= n28 <= 532443:
            m = n28 - 1003
            letters = []
            while m:
                letters.append(chr(ord("A") + (m % 27) - 1))
                m //= 27
            return "CQ " + "".join(reversed(letters))
        raise UnpackError(f"reserved token {n28}")
    if n28 < NTOKENS + MAX22:
        h = n28 - NTOKENS
        call = hashes.lookup(h, 22) if hashes else None
        return f"<{call}>" if call else "<...>"
    n = n28 - NTOKENS - MAX22
    c6 = A4[n % 27]; n //= 27
    c5 = A4[n % 27]; n //= 27
    c4 = A4[n % 27]; n //= 27
    c3 = A3[n % 10]; n //= 10
    c2 = A2[n % 36]; n //= 36
    if n >= len(A1):
        raise UnpackError("bad standard callsign index")
    c1 = A1[n]
    call = (c1 + c2 + c3 + c4 + c5 + c6).strip()
    if ip:
        call += "/R" if i3 == 1 else "/P"
    return call


def unpack_grid_15(g15: int, ir: int) -> str:
    if g15 <= MAXGRID4:
        g = g15
        c1 = chr(ord("A") + g // (18 * 100))
        g %= 18 * 100
        c2 = chr(ord("A") + g // 100)
        g %= 100
        field = f"{c1}{c2}{g // 10}{g % 10}"
    else:
        irpt = g15 - MAXGRID4
        if irpt == 1:
            field = ""
        elif irpt == 2:
            field = "RRR"
        elif irpt == 3:
            field = "RR73"
        elif irpt == 4:
            field = "73"
        else:
            field = f"{irpt - 35:+03d}"
    if ir and field:
        # reports combine as a single "R-09"-style token; grids keep a space
        field = ("R" + field) if field[0] in "+-" else ("R " + field)
    return field


def _unpack_free_text(bits71) -> str:
    v = _int_from_bits(bits71)
    chars = []
    for _ in range(13):
        chars.append(FREE_TEXT_ALPHABET[v % 42])
        v //= 42
    return "".join(reversed(chars)).strip()


def _unpack_nonstd(bits, hashes) -> str:
    # i3=4: h12 (12) + c58 (58) + h1 (1) + r2 (2) + c1 (1)
    h12 = _int_from_bits(bits[0:12])
    n58 = _int_from_bits(bits[12:70])
    h1 = int(bits[70])
    r2 = _int_from_bits(bits[71:73])
    c1 = int(bits[73])
    from .text import c58_to_call
    call = c58_to_call(n58)
    if hashes is not None:
        hashes.add(call)
    other = hashes.lookup(h12, 12) if hashes else None
    other_s = f"<{other}>" if other else "<...>"
    rpt = {0: "", 1: "RRR", 2: "RR73", 3: "73"}[r2]
    if c1:
        return f"CQ {call}" + (f" {rpt}" if rpt else "")
    a, b = (other_s, call) if h1 == 0 else (call, other_s)
    return f"{a} {b}" + (f" {rpt}" if rpt else "")


def unpack77(payload_bits: np.ndarray,
             hashes: CallsignHashTable | None = None) -> str:
    """Decode 77 payload bits to message text."""
    bits = np.asarray(payload_bits).astype(np.int64)
    i3 = _int_from_bits(bits[74:77])
    if i3 == 0:
        n3 = _int_from_bits(bits[71:74])
        if n3 == 0:
            return _unpack_free_text(bits[0:71])
        if n3 == 1:
            # DXpedition: c28 c28 h10 r5 -> "TO RR73; DE <HASH> +NN"
            n28a = _int_from_bits(bits[0:28])
            n28b = _int_from_bits(bits[28:56])
            h10 = _int_from_bits(bits[56:66])
            r5 = _int_from_bits(bits[66:71])
            ca = unpack_callsign_28(n28a, 0, 1, hashes)
            cb = unpack_callsign_28(n28b, 0, 1, hashes)
            other = hashes.lookup(h10, 10) if hashes else None
            other_s = f"<{other}>" if other else "<...>"
            return f"{ca} RR73; {cb} {other_s} {2 * r5 - 30:+03d}"
        if n3 in (3, 4):
            # ARRL Field Day: c28 c28 R1 n4 k3 S7; ntx 1-16 (n3=3) or
            # 17-32 (n3=4)
            from .text import ARRL_SECTIONS
            n28a = _int_from_bits(bits[0:28])
            n28b = _int_from_bits(bits[28:56])
            ir = int(bits[56])
            intx = _int_from_bits(bits[57:61])
            klass = _int_from_bits(bits[61:64])
            s7 = _int_from_bits(bits[64:71])
            ca = unpack_callsign_28(n28a, 0, 1, hashes)
            cb = unpack_callsign_28(n28b, 0, 1, hashes)
            ntx = intx + 1 if n3 == 3 else intx + 17
            if klass > 5 or not 1 <= s7 <= len(ARRL_SECTIONS):
                raise UnpackError(f"bad Field Day exchange {klass}/{s7}")
            sec = ARRL_SECTIONS[s7 - 1]
            parts = [ca, cb] + (["R"] if ir else []) \
                + [f"{ntx}{chr(ord('A') + klass)}", sec]
            return " ".join(parts)
        if n3 == 5:
            v = _int_from_bits(bits[0:71])
            return f"{v:018X}"
        # n3 2 (EU VHF) / 6 / 7: surface as typed raw payload
        v = _int_from_bits(bits[0:71])
        return f"<type0.{n3}:{v:018X}>"
    if i3 in (1, 2):
        n28a = _int_from_bits(bits[0:28]); ipa = int(bits[28])
        n28b = _int_from_bits(bits[29:57]); ipb = int(bits[57])
        ir = int(bits[58])
        g15 = _int_from_bits(bits[59:74])
        ca = unpack_callsign_28(n28a, ipa, i3, hashes)
        cb = unpack_callsign_28(n28b, ipb, i3, hashes)
        if hashes is not None:
            for c in (ca, cb):
                if not c.startswith("<") and not c.startswith("CQ"):
                    hashes.add(c.replace("/R", "").replace("/P", ""))
        field3 = unpack_grid_15(g15, ir)
        msg = f"{ca} {cb}"
        if field3:
            msg += f" {field3}"
        return msg
    if i3 == 3:
        # RTTY Roundup: t1 c28 c28 R1 r3 s13 -> "TU; A B R 579 0123"
        tu = int(bits[0])
        n28a = _int_from_bits(bits[1:29])
        n28b = _int_from_bits(bits[29:57])
        ir = int(bits[57])
        r3 = _int_from_bits(bits[58:61])
        s13 = _int_from_bits(bits[61:74])
        ca = unpack_callsign_28(n28a, 0, i3, hashes)
        cb = unpack_callsign_28(n28b, 0, i3, hashes)
        rpt = f"5{r3 + 2}9"
        parts = (["TU;"] if tu else []) + [ca, cb] \
            + (["R"] if ir else []) + [rpt, f"{s13:04d}"]
        return " ".join(parts)
    if i3 == 4:
        return _unpack_nonstd(bits, hashes)
    # i3 5..7: not implemented — surface as typed raw payload
    v = _int_from_bits(bits[0:74])
    return f"<type{i3}:{v:019X}>"


def unpack_spot(payload_bits: np.ndarray,
                hashes: CallsignHashTable | None = None):
    """Decode to (text, call, loc, is_cq) with call/loc taken from the
    77-bit FIELDS, not from re-parsing the text.

    The reference extracts spots by strtok'ing the text (rtlsdr_ft8d.c:
    1509-1521), which misparses e.g. 'CQ RAEM KO85' (a genuine 4-letter
    callsign looks like a directed-CQ modifier). The payload already
    distinguishes the CQ token (c28a) from the sender (c28b), so derive
    structurally for i3 1/2/4 and fall back to text only for free text."""
    bits = np.asarray(payload_bits).astype(np.int64)
    text = unpack77(bits, hashes)
    i3 = _int_from_bits(bits[74:77])
    call, loc, is_cq = "", "", False
    if i3 in (1, 2):
        n28a = _int_from_bits(bits[0:28])
        is_cq = 2 <= n28a <= 532443          # CQ / CQ nnn / CQ AAAA
        n28b = _int_from_bits(bits[29:57])
        ipb = int(bits[57])
        ir = int(bits[58])
        g15 = _int_from_bits(bits[59:74])
        # no try/except: unpack77 above already decoded the same
        # (n28b, ipb, i3) and would have raised
        call = unpack_callsign_28(n28b, ipb, i3, hashes)
        if call.startswith("<"):
            call = call.strip("<>").replace("...", "")
        if not ir and g15 <= MAXGRID4:
            loc = unpack_grid_15(g15, 0)
    elif i3 == 3:
        n28a = _int_from_bits(bits[1:29])
        is_cq = 2 <= n28a <= 532443
        call = unpack_callsign_28(_int_from_bits(bits[29:57]), 0, i3,
                                  hashes)
        if call.startswith("<"):
            call = call.strip("<>").replace("...", "")
    elif i3 == 4:
        from .text import c58_to_call
        c1 = int(bits[73])
        h1 = int(bits[70])
        if c1:                               # "CQ CALL"
            is_cq = True
            call = c58_to_call(_int_from_bits(bits[12:70]))
        elif h1 == 0:
            # "<OTHER> CALL [rpt]": the c58 call sits in the sender
            # slot, so spot it (i3 1/2/3 extract non-CQ senders too;
            # h1==1 puts only the 12-bit hash in the sender slot)
            call = c58_to_call(_int_from_bits(bits[12:70]))
    else:
        is_cq = text.startswith("CQ ")
        parts = text.split()
        if is_cq and len(parts) >= 2:
            call = parts[1]
    return text, call, loc, is_cq


# byte -> base-38 digit of HASH_ALPHABET (lower case as upper case; any
# other byte, NUL included, counts as the space, digit 0)
_HASH_DIGITS = np.zeros(256, np.uint64)
for _d, _ch in enumerate(HASH_ALPHABET):
    _HASH_DIGITS[ord(_ch)] = _HASH_DIGITS[ord(_ch.lower())] = _d
# ASCII bytes that str.strip() removes or str.upper() changes
_NEEDS_NORM = np.array([chr(b).isspace() or chr(b).islower()
                        for b in range(256)]) & (np.arange(256) < 128)


def hash_calls_22(calls):
    """hash_callsign(call, 22) of many calls at once.

    `calls`: an array of ASCII bytes (numpy "S" dtype), such as the add
    fields of the native spot records. Returns the hashes as a list of
    ints and each call as CallsignHashTable.add stores it (stripped,
    upper case) as a list of str. A call that needs stripping or lower
    case letters raised is normalized on its own; the others, and the
    base-38 Horner sum over the first 11 characters, in bulk.
    """
    calls = np.array(calls, dtype=np.bytes_).ravel()
    width = max(calls.dtype.itemsize, 11)
    calls = calls.astype(f"S{width}")
    raw = calls.view(np.uint8).reshape(calls.size, width)
    for i in np.flatnonzero(_NEEDS_NORM[raw].any(axis=1)):
        calls[i] = calls[i].decode().strip().upper().encode()
    n = np.zeros(calls.size, np.uint64)
    for digit in _HASH_DIGITS[raw[:, :11]].T:
        n = n * np.uint64(38) + digit
    h22 = (n * np.uint64(47055833459)) >> np.uint64(64 - 22)
    return h22.tolist(), calls.astype(f"U{width}").tolist()


def _gather(items, at):
    """[items[i] for i in at], in bulk."""
    return np.array(items, object)[at].tolist()


def unpack_spot_columns(packed12, hashes=None, table_of=None):
    """Batched unpack of bit-packed 91-bit payloads (N, 12) uint8 into
    columns: (text, call, loc, is_cq, n_python). The four are lists of
    str and bool as unpack_spot returns them, with text None for a record
    that fails to unpack; n_python counts the records unpacked one at a
    time in Python.

    `hashes` is one CallsignHashTable (or None) for every record, or a
    list of them with `table_of` (N,) naming each record's index in it.
    The tables end as unpack_spot record by record in order leaves them:
    one native call renders every record and the hash-table ADD side
    effects it computed are stored in bulk, while a record that needs a
    hash-table LOOKUP is re-unpacked by unpack_spot at its place in the
    order. Without the native library every record goes through
    unpack_spot.
    """
    import ctypes

    from .. import native

    packed12 = np.ascontiguousarray(packed12, np.uint8)
    n = packed12.shape[0]
    if not isinstance(hashes, (list, tuple)):
        hashes, table_of = [hashes], np.zeros(n, np.intp)
    table_of = np.asarray(table_of, np.intp)
    lib = native.load() if n else None
    if lib is None:
        text, call, loc, is_cq = [None] * n, [""] * n, [""] * n, [False] * n
        for i, t in enumerate(table_of.tolist()):
            try:
                text[i], call[i], loc[i], is_cq[i] = unpack_spot(
                    np.unpackbits(packed12[i])[:77], hashes[t])
            except UnpackError:
                pass
        return text, call, loc, is_cq, n
    # The native unpack is stateless, so each distinct payload is rendered
    # once (a signal survives at several candidates); every record still
    # makes its own table side effects, in order, below.
    distinct, first, inverse = np.unique(packed12.view("V12").ravel(),
                                         return_index=True,
                                         return_inverse=True)
    inverse = inverse.ravel()
    rows = packed12[first]
    recs = np.zeros(distinct.size, native.SPOT_DTYPE)
    lib.ft8_unpack_spot_batch(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows.shape[0],
        recs.ctypes.data_as(ctypes.POINTER(native.Ft8SpotText)))
    text = _gather(recs["text"].astype("U64").tolist(), inverse)
    call = _gather(recs["call"].astype("U16").tolist(), inverse)
    loc = _gather(recs["loc"].astype("U8").tolist(), inverse)
    is_cq = _gather(recs["is_cq"].astype(bool).tolist(), inverse)
    ok = recs["rc"][inverse] == 0
    for i in np.flatnonzero(~ok):
        text[i] = None
    has_table = np.array([h is not None for h in hashes])[table_of]
    redo = ok & (recs["has_hash"][inverse] != 0) & has_table
    adds = ok & ~redo & has_table
    if not (adds.any() or redo.any()):
        return text, call, loc, is_cq, 0
    # each record's add_a then add_b; the blank pair at the end where
    # nothing is added
    h22, calls = hash_calls_22(np.stack([recs["add_a"], recs["add_b"]], 1))
    pair = np.where(adds[:, None], 2 * inverse[:, None] + np.arange(2),
                    2 * distinct.size).ravel()
    h22, calls = _gather(h22 + [0], pair), _gather(calls + [""], pair)
    # runs of records with one table and no lookup, cut around each lookup
    redo_at = np.flatnonzero(redo)
    bounds = np.union1d(np.flatnonzero(np.diff(table_of)) + 1,
                        np.concatenate([[0, n], redo_at, redo_at + 1]))
    bounds = bounds.tolist()
    for s, e in zip(bounds[:-1], bounds[1:]):
        table = hashes[table_of[s]]
        if table is None:
            continue
        if redo[s]:
            try:
                text[s], call[s], loc[s], is_cq[s] = unpack_spot(
                    np.unpackbits(packed12[s])[:77], table)
            except UnpackError:
                text[s] = None
        else:
            table.add_hashed(h22[2 * s:2 * e], calls[2 * s:2 * e])
    return text, call, loc, is_cq, redo_at.size


def unpack_spots_batch(packed12, hashes: CallsignHashTable | None = None):
    """Batched unpack of bit-packed 91-bit payloads (N, 12) uint8.

    unpack_spot_columns over one table, as a list of (text, call, loc,
    is_cq) tuples, None for records that fail to unpack (exact parity
    with sequential unpack_spot). Falls back to pure Python without the
    native lib.
    """
    text, call, loc, is_cq, _ = unpack_spot_columns(packed12, hashes)
    return [None if t is None else (t, c, g, q)
            for t, c, g, q in zip(text, call, loc, is_cq)]
