"""Seeded FT8 message texts: the standard exchanges of a QSO over valid
standard callsigns and 4-character grids."""

import numpy as np

PREFIXES = ("K", "W", "N", "G", "F", "I", "DL", "VK", "JA", "EA", "UA",
            "VE", "PY", "LU", "ZL", "OH", "SM", "ON", "PA", "OK", "SP",
            "YO", "HA", "VA", "KB", "WA", "IK", "DK", "EI", "LA")
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
FIELD = "ABCDEFGHIJKLMNOPQR"
# exchange kinds and their shares in a busy band
KINDS = ("cq", "grid", "report", "r_report", "rr73", "73")


def callsign(rng) -> str:
    suffix = "".join(rng.choice(list(LETTERS), size=int(rng.integers(1, 4))))
    return f"{rng.choice(PREFIXES)}{int(rng.integers(0, 10))}{suffix}"


def grid(rng) -> str:
    return (f"{rng.choice(list(FIELD))}{rng.choice(list(FIELD))}"
            f"{int(rng.integers(0, 10))}{int(rng.integers(0, 10))}")


def report(rng) -> str:
    return f"{int(rng.integers(-24, 11)):+03d}"


def message(rng, shares) -> str:
    """One exchange text; `shares` maps each of KINDS to its weight."""
    w = np.asarray([shares[k] for k in KINDS], np.float64)
    kind = KINDS[int(rng.choice(len(KINDS), p=w / w.sum()))]
    a, b = callsign(rng), callsign(rng)
    if kind == "cq":
        return f"CQ {a} {grid(rng)}"
    if kind == "grid":
        return f"{a} {b} {grid(rng)}"
    if kind == "report":
        return f"{a} {b} {report(rng)}"
    if kind == "r_report":
        return f"{a} {b} R{report(rng)}"
    if kind == "rr73":
        return f"{a} {b} RR73"
    return f"{a} {b} 73"


def canonical(text: str) -> str:
    """The text a decoder prints for `text`: its 77 bits unpacked."""
    from reference.protocol.pack import pack77
    from reference.protocol.unpack import unpack77

    return unpack77(pack77(text))
