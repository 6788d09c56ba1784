# Copied from rtlsdr_ft8d_tpu/native/__init__.py:1-128; the default
# library path and its build step are the port's (ops/build.py).
"""ctypes bindings for the native C++ runtime (libft8tpu.so).

Built from native/*.cc by ops/build.build_native at first use. Loading
is lazy and optional: every native function has a pure-Python equivalent
in the package, so the framework degrades gracefully when the library has
not been built.
"""

import ctypes
import os

import numpy as np

from .ops import build

_LIB = None
_TRIED = False

# FT8_TPU_NATIVE_SO overrides the library path — used by `make sanitize`
# to run the test suite against the ASan/UBSan build of the same sources.
# By default: the library ops/build.build_native compiles from the
# repo-level native/*.cc into the port's build directory.
_SO = os.environ.get("FT8_TPU_NATIVE_SO", build.native_library_path())


class Ft8Spot(ctypes.Structure):
    _fields_ = [
        ("call", ctypes.c_char * 16),
        ("locator", ctypes.c_char * 8),
        ("freq_hz", ctypes.c_uint32),
        ("snr_db", ctypes.c_int8),
        ("epoch", ctypes.c_uint32),
    ]


class Ft8SpotText(ctypes.Structure):
    """Mirror of native/ft8codec.cc:Ft8SpotText (batched spot unpack)."""
    _fields_ = [
        ("text", ctypes.c_char * 64),
        ("call", ctypes.c_char * 16),
        ("loc", ctypes.c_char * 8),
        ("add_a", ctypes.c_char * 16),
        ("add_b", ctypes.c_char * 16),
        ("is_cq", ctypes.c_uint8),
        ("has_hash", ctypes.c_uint8),
        ("rc", ctypes.c_int8),
        ("pad_", ctypes.c_uint8),
    ]


def _record_dtype(struct):
    """A ctypes Structure as a numpy record at the same offsets, with its
    char arrays as byte strings ("S<n>")."""
    def fmt(ctype):
        if issubclass(ctype, ctypes.Array) and ctype._type_ is ctypes.c_char:
            return f"S{ctypes.sizeof(ctype)}"
        return np.dtype(ctype)
    return np.dtype({"names": [n for n, _ in struct._fields_],
                     "formats": [fmt(t) for _, t in struct._fields_],
                     "offsets": [getattr(struct, n).offset
                                 for n, _ in struct._fields_],
                     "itemsize": ctypes.sizeof(struct)})


# Ft8SpotText as a numpy record, for reading a batch in bulk. The native
# code zeroes each record and writes every text field once by snprintf,
# so numpy's reading of a field (up to its last non-NUL byte) is C's (up
# to its first NUL).
SPOT_DTYPE = _record_dtype(Ft8SpotText)


def load(build_if_missing=True):
    """Return the loaded library or None.

    FT8_TPU_REQUIRE_NATIVE=1 turns a load failure into a hard error so a
    sanitizer/CI run cannot silently fall back to the pure-Python paths.
    """
    global _LIB, _TRIED
    required = os.environ.get("FT8_TPU_REQUIRE_NATIVE") == "1"
    if _LIB is not None or _TRIED and not build_if_missing:
        if _LIB is None and required:
            raise OSError(f"native library unavailable: {_SO} "
                          "(FT8_TPU_REQUIRE_NATIVE=1; a prior load failed)")
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO) and build_if_missing:
        try:
            build.build_native()
        except Exception:
            if required:
                raise
            return None
    if not os.path.exists(_SO):
        if required:
            raise OSError(f"native library missing: {_SO} "
                          "(FT8_TPU_REQUIRE_NATIVE=1)")
        return None
    lib = ctypes.CDLL(_SO)
    lib.ft8_crc14.restype = ctypes.c_uint16
    lib.ft8_crc14.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.ft8_encode_tones.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.POINTER(ctypes.c_uint8)]
    lib.ft8_ldpc_check.restype = ctypes.c_int
    lib.ft8_ldpc_check.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.ft8_pack77.restype = ctypes.c_int
    lib.ft8_pack77.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_uint8)]
    lib.ft8_unpack77.restype = ctypes.c_int
    lib.ft8_unpack77.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                 ctypes.c_char_p, ctypes.c_size_t]
    lib.ft8_hash22.restype = ctypes.c_uint32
    lib.ft8_hash22.argtypes = [ctypes.c_char_p]
    lib.ipfix_build_frame.restype = ctypes.c_int
    lib.ipfix_build_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(Ft8Spot),
        ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
    lib.ipfix_send_udp.restype = ctypes.c_int
    lib.ipfix_send_udp.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.c_int]
    lib.ingest_ring_create.restype = ctypes.c_void_p
    lib.ingest_ring_create.argtypes = [ctypes.c_size_t]
    lib.ingest_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_ring_push_u8.restype = ctypes.c_size_t
    lib.ingest_ring_push_u8.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint8),
                                        ctypes.c_size_t]
    lib.ingest_ring_pop.restype = ctypes.c_size_t
    lib.ingest_ring_pop.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int8),
                                    ctypes.POINTER(ctypes.c_int8),
                                    ctypes.c_size_t]
    lib.ingest_ring_available.restype = ctypes.c_size_t
    lib.ingest_ring_available.argtypes = [ctypes.c_void_p]
    lib.ingest_ring_discard.restype = ctypes.c_size_t
    lib.ingest_ring_discard.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.ingest_ring_dropped.restype = ctypes.c_uint64
    lib.ingest_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.ft8_unpack_spot_batch.restype = ctypes.c_int
    lib.ft8_unpack_spot_batch.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                          ctypes.c_int,
                                          ctypes.POINTER(Ft8SpotText)]
    lib.ft8_osd_batch.restype = ctypes.c_int
    lib.ft8_osd_batch.argtypes = [ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_double,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return _LIB
