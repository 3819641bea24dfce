"""TUN device IO via the native helper library (ctypes).

Equivalent of TunSource/TunSink (tun_source.hpp:15-153,
tun_sink.hpp:15-44): IP packets enter/leave the modem through a Linux TUN
device, optionally inside a named network namespace (tun.hpp:28-57). The
native library (native/tunio.cpp) provides the fd plumbing and a lock-free
SPSC ring buffer; this module adds the packet-level API and the idle-packet /
latency-credit behavior lives in the runtime layer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

__all__ = ["native_lib", "TunDevice", "build_native"]

_LIB_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "libpmtun.so"
)
_lib = None


def build_native() -> bool:
    """Build the native library if missing. Returns availability."""
    if os.path.exists(_LIB_PATH):
        return True
    makedir = os.path.dirname(_LIB_PATH)
    try:
        subprocess.run(["make", "-C", makedir], check=True, capture_output=True)
    except Exception:
        return False
    return os.path.exists(_LIB_PATH)


def native_lib():
    """Load (building if needed) the native IO library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.pm_tun_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pm_tun_open.restype = ctypes.c_int
    lib.pm_read_timeout.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.pm_read_timeout.restype = ctypes.c_int
    lib.pm_write.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.pm_write.restype = ctypes.c_int
    lib.pm_close.argtypes = [ctypes.c_int]
    lib.pm_close.restype = ctypes.c_int
    lib.pm_ring_create.argtypes = [ctypes.c_size_t]
    lib.pm_ring_create.restype = ctypes.c_void_p
    lib.pm_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.pm_ring_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.pm_ring_write.restype = ctypes.c_size_t
    lib.pm_ring_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.pm_ring_read.restype = ctypes.c_size_t
    lib.pm_ring_readable.argtypes = [ctypes.c_void_p]
    lib.pm_ring_readable.restype = ctypes.c_size_t
    _lib = lib
    return _lib


class TunDevice:
    """A TUN device for IP packet ingress/egress.

    Needs root (CAP_NET_ADMIN); see scripts/netns-setup in the reference for
    the namespace topology this mirrors.
    """

    MAX_PACKET = 65535

    def __init__(self, name: str = "tun0", netns: str = ""):
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native IO library unavailable")
        self._lib = lib
        fd = lib.pm_tun_open(name.encode(), netns.encode())
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd), f"tun {name} netns={netns!r}")
        self.fd = fd
        self._buf = ctypes.create_string_buffer(self.MAX_PACKET)

    def read_packet(self, timeout_ms: int = 100) -> bytes | None:
        """Read one IP packet; None on timeout."""
        n = self._lib.pm_read_timeout(
            self.fd, self._buf, self.MAX_PACKET, timeout_ms
        )
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        if n == 0:
            return None
        return self._buf.raw[:n]

    def write_packet(self, packet: bytes) -> int:
        """Write one IP packet; errors are tolerated (returns <0 errno) the
        way TunSink tolerates malformed decoder output (tun_sink.hpp:33-37)."""
        return self._lib.pm_write(self.fd, packet, len(packet))

    def close(self):
        if self.fd >= 0:
            self._lib.pm_close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
