# Copied from rtlsdr_ft8d_tpu/protocol/text.py:1-116.
"""Character tables and callsign helpers shared by pack/unpack.

Equivalent in role to ft8_lib's text.c (consumed by the reference via
pack77/unpack calls at rtlsdr_ft8d.c:927,1494).
"""

# Alphabet for free-text (type 0.0) packing, base 42.
FREE_TEXT_ALPHABET = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?"

# Base-38 alphabet used for callsign hashing.
HASH_ALPHABET = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"

# Standard callsign character classes.
A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"  # 37
A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"   # 36
A3 = "0123456789"                              # 10
A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"             # 27

NTOKENS = 2063592
MAX22 = 4194304
MAXGRID4 = 32400

# ARRL/RAC section abbreviations for Field Day messages (i3=0, n3=3/4),
# indexed by the 7-bit S7 field (1-based; 0 is unused). Transcribed from
# ARRL's published section list in the ordering used by amateur contest
# software (alphabetical); this table is the single source of truth — the
# native header's copy is generated from it (scripts/gen_native_tables.py).
ARRL_SECTIONS = [
    "AB", "AK", "AL", "AR", "AZ", "BC", "CO", "CT", "DE", "EB",
    "EMA", "ENY", "EPA", "EWA", "GA", "GTA", "IA", "ID", "IL", "IN",
    "KS", "KY", "LA", "LAX", "MAR", "MB", "MDC", "ME", "MI", "MN",
    "MO", "MS", "MT", "NC", "ND", "NE", "NFL", "NH", "NL", "NLI",
    "NM", "NNJ", "NNY", "NT", "NTX", "NV", "OH", "OK", "ONE", "ONN",
    "ONS", "OR", "ORG", "PAC", "PR", "QC", "RI", "SB", "SC", "SCV",
    "SD", "SDG", "SF", "SFL", "SJV", "SK", "SNJ", "STX", "TN", "VA",
    "VI", "VT", "WCF", "WI", "WMA", "WNY", "WPA", "WTX", "WV", "WWA",
    "WY", "DX",
]


def is_standard_callsign(call: str) -> bool:
    """True if `call` fits the 6-char [A1][A2][A3][A4][A4][A4] template."""
    return normalize_standard(call) is not None


def normalize_standard(call: str):
    """Return the 6-char padded form of a standard callsign, or None.

    Standard template: up to 2 prefix chars (2nd must exist), a digit, then
    up to 3 letter suffix chars. Calls like K1JT -> ' K1JT ', otherwise the
    3rd char must be the digit.
    """
    call = call.strip().upper()
    if not 2 <= len(call) <= 6 or "/" in call:
        return None
    # find digit position: must be index 1 or 2 in the padded form
    c = call
    if len(c) >= 3 and c[2].isdigit():
        padded = c.ljust(6)
    elif len(c) >= 2 and c[1].isdigit():
        padded = (" " + c).ljust(6)
    else:
        return None
    if len(padded) != 6:
        return None
    if (padded[0] in A1 and padded[1] in A2 and padded[2] in A3
            and all(ch in A4 for ch in padded[3:6])):
        return padded
    return None


def c58_to_call(n58: int) -> str:
    """Decode the i3=4 58-bit base-38 field to its 11-char callsign
    (stripped). ONE copy shared by unpack77 and the spot extractor —
    the native side keeps its single copy in spot_fields."""
    chars = []
    for _ in range(11):
        chars.append(HASH_ALPHABET[n58 % 38])
        n58 //= 38
    return "".join(reversed(chars)).strip()


def hash_callsign(call: str, nbits: int) -> int:
    """FT8 22/12/10-bit callsign hash (multiplicative, base-38 packing)."""
    call = call.strip().upper()[:11].ljust(11)
    n = 0
    for ch in call:
        n = n * 38 + HASH_ALPHABET.index(ch if ch in HASH_ALPHABET else " ")
    h = (47055833459 * n) & ((1 << 64) - 1)
    return h >> (64 - nbits)


class CallsignHashTable:
    """Host-side store mapping 22/12/10-bit hashes back to callsigns.

    The reference's ft8_lib keeps an equivalent table so <...> hashed calls
    in decoded messages can be resolved across a session.
    """

    def __init__(self):
        self._by22 = {}

    def add(self, call: str):
        call = call.strip().upper()
        if not call or call.startswith("<"):
            return
        self._by22[hash_callsign(call, 22)] = call

    def add_hashed(self, h22s, calls):
        """add() each of `calls` under its precomputed 22-bit hash, in
        order, so a later pair wins as with repeated add. The calls are
        as add stores them (stripped, upper case), as
        protocol/unpack.py:hash_calls_22 returns them; add's rules skip
        the empty ones and those that start with '<'."""
        self._by22.update((h, c) for h, c in zip(h22s, calls)
                          if c and c[0] != "<")

    def lookup(self, h: int, nbits: int):
        if nbits == 22:
            return self._by22.get(h)
        shift = 22 - nbits
        for h22, call in self._by22.items():
            if h22 >> shift == h:
                return call
        return None
