"""Complex-array helpers: plane-wise indexing and host transfer.

``ctake``/``cgather``/``cdynslice`` index the I/Q planes of a complex array
separately; ``to_host``/``to_device`` move complex data between host and
device as real planes; ``to_transfer_planes``/``planes_to_complex`` pack
host samples into one real (optionally quantized) wire array and unpack it
inside the consumer's jit.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ctake", "cgather", "cdynslice", "slice_windows", "to_host", "to_device",
    "to_transfer_planes", "planes_to_complex", "INT8_SCALE", "INT4_SCALE",
]


def ctake(a: jax.Array, indices, axis: int = 0) -> jax.Array:
    """``jnp.take`` over the I/Q planes of complex arrays."""
    if jnp.iscomplexobj(a):
        return jax.lax.complex(
            jnp.take(a.real, indices, axis=axis),
            jnp.take(a.imag, indices, axis=axis),
        )
    return jnp.take(a, indices, axis=axis)


def cgather(a: jax.Array, *idx) -> jax.Array:
    """``a[idx...]`` advanced indexing over the I/Q planes of complex
    arrays."""
    if jnp.iscomplexobj(a):
        return jax.lax.complex(a.real[idx], a.imag[idx])
    return a[idx]


def cdynslice(a: jax.Array, start, size: int) -> jax.Array:
    """1-D ``lax.dynamic_slice`` over the I/Q planes of complex arrays."""
    if jnp.iscomplexobj(a):
        return jax.lax.complex(
            jax.lax.dynamic_slice(a.real, (start,), (size,)),
            jax.lax.dynamic_slice(a.imag, (start,), (size,)),
        )
    return jax.lax.dynamic_slice(a, (start,), (size,))


def slice_windows(a: jax.Array, starts: jax.Array, size: int) -> jax.Array:
    """``[a[s : s + size] for s in starts]`` of a 1-D real array as one
    batched slice ``[D, size]`` (vmapped dynamic slices lower to a single
    gather). Callers clip starts to ``[0, len(a) - size]``; as in
    ``lax.dynamic_slice``, a start past ``len(a) - size`` is clamped (a
    window never reads past the end) and a negative start counts from the
    end."""
    return jax.vmap(lambda s: jax.lax.dynamic_slice(a, (s,), (size,)))(starts)


def to_host(x) -> np.ndarray:
    """Device -> numpy, transferring complex data as separate I/Q planes."""
    if jnp.iscomplexobj(x):
        re = np.asarray(x.real)
        im = np.asarray(x.imag)
        return (re + 1j * im).astype(np.complex64 if re.dtype == np.float32
                                     else np.complex128)
    return np.asarray(x)


# fixed-point scale for int8 transfer planes: the modem's burst amplitude is
# ~1 (BurstShaper ramps to unity), so +-127/64 = +-1.98 of headroom with a
# 42 dB quantization SNR floor — far above the 20 dB operating Es/N0
INT8_SCALE = 64.0

# fixed-point scale for the packed-int4 wire (two samples per byte): +-7/3.5
# = +-2.0 headroom with a ~21.7 dB quantization SNR floor — still far above
# the QPSK decode threshold; combined with a 20 dB channel the effective
# Es/N0 is ~17.8 dB, comfortably inside the modem's operating region, and
# the serving parity gates prove byte-exact decode on the actual traffic
INT4_SCALE = 3.5


def _quantize_int8_into(src: np.ndarray, dst: np.ndarray) -> None:
    """``dst[:] = clip(round(src * INT8_SCALE))`` in one thread-parallel
    pass. ``src`` may be a strided view (``x.real`` of complex input) —
    the multiply reads it directly, so the de-interleave rides the same
    pass instead of a serial ``ascontiguousarray`` copy. Numpy ufuncs
    release the GIL, so chunking over a thread pool scales with cores —
    the serial multi-pass form measured ~470 ms for a 64-channel 2^19
    block on the streaming path (the dominant host cost)."""
    from concurrent.futures import ThreadPoolExecutor

    if src.size == 0:
        return
    flat_src = src.reshape(-1) if src.ndim > 1 and src.flags.c_contiguous \
        else src
    if flat_src.ndim > 1:  # strided view: chunk over leading axis
        rows = flat_src.shape[0]
        # match dst's view to the source's full shape so chunk assignment is
        # shape-exact for any ndim (a 2-D dst view would reject >2-D chunks)
        dst2 = dst.reshape(flat_src.shape)
        workers = max(1, min(8, os.cpu_count() or 1, rows))
        rchunk = -(-rows // workers)

        def work(i):
            s = slice(i * rchunk, min((i + 1) * rchunk, rows))
            tmp = np.multiply(flat_src[s], INT8_SCALE)
            np.rint(tmp, out=tmp)
            np.clip(tmp, -127, 127, out=tmp)
            dst2[s] = tmp
    else:
        flat_dst = dst.reshape(-1)
        n = flat_src.size
        workers = min(8, os.cpu_count() or 1)
        chunk = -(-n // workers)

        def work(i):
            s = slice(i * chunk, min((i + 1) * chunk, n))
            tmp = np.multiply(flat_src[s], INT8_SCALE)
            np.rint(tmp, out=tmp)
            np.clip(tmp, -127, 127, out=tmp)
            flat_dst[s] = tmp  # cast on assignment

    if src.size < (1 << 20) or workers == 1:
        for i in range(workers):
            work(i)
        return
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(work, range(workers)))


def _quantize_int4_into(src: np.ndarray, dst: np.ndarray) -> None:
    """``dst`` = biased-int4 sample pairs of ``src`` packed two-per-byte
    (``clip(round(src*INT4_SCALE), -7, 7) + 8``), thread-parallel like
    :func:`_quantize_int8_into` — the single-pass form cost hundreds of ms
    per 64-channel block on the serving path. ``src`` may be a strided
    plane view; ``dst`` has half its last axis."""
    from concurrent.futures import ThreadPoolExecutor

    if src.size == 0:
        return
    src2 = src.reshape(-1, src.shape[-1]) if src.ndim > 1 else src[None]
    dst2 = dst.reshape(src2.shape[0], -1)
    rows = src2.shape[0]
    # chunk along rows when there are several; otherwise along the (even)
    # sample axis of the single row
    if rows > 1:
        workers = max(1, min(8, os.cpu_count() or 1, rows))
        bounds = [
            (slice(i * -(-rows // workers),
                   min((i + 1) * -(-rows // workers), rows)),
             slice(None))
            for i in range(workers)
        ]
    else:
        n = src2.shape[1]
        workers = max(1, min(8, os.cpu_count() or 1))
        step = (-(-n // workers) + 1) // 2 * 2  # even split
        bounds = [
            (slice(0, 1), slice(i * step, min((i + 1) * step, n)))
            for i in range(workers)
        ]

    def work(b):
        rs, cs = b
        tmp = np.multiply(src2[rs, cs], INT4_SCALE)
        np.rint(tmp, out=tmp)
        np.clip(tmp, -7, 7, out=tmp)
        q = (tmp + 8.0).astype(np.uint8)
        dcs = slice(
            (cs.start or 0) // 2,
            None if cs.stop is None else -(-cs.stop // 2),
        )
        dst2[rs, dcs] = q[..., 0::2] | (q[..., 1::2] << 4)

    if src.size < (1 << 20) or workers == 1:
        for b in bounds:
            work(b)
        return
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(work, bounds))


def to_transfer_planes(x: np.ndarray, transfer_dtype=None) -> np.ndarray:
    """Pack complex host samples into ONE ``[2, ...]`` real plane array in
    the wire dtype (f32 / bf16 / int8 fixed-point / ``"int4"`` packed
    fixed-point — two samples per byte, the last axis halves). A single
    contiguous array = a single h2d transfer; the inverse
    (``planes_to_complex``) runs inside the consumer's jit so no unjitted
    device ops are dispatched."""
    x = np.asarray(x)
    if isinstance(transfer_dtype, str) and transfer_dtype == "int4":
        if x.shape[-1] % 2:
            raise ValueError("int4 wire needs an even last axis")
        out = np.empty((2,) + x.shape[:-1] + (x.shape[-1] // 2,), np.uint8)
        _quantize_int4_into(x.real, out[0])
        _quantize_int4_into(x.imag, out[1])
        return out
    if transfer_dtype is not None and jnp.dtype(transfer_dtype) == jnp.int8:
        out = np.empty((2,) + x.shape, np.int8)
        # strided .real/.imag views feed the quantizer directly: the
        # de-interleave happens inside its thread-parallel pass
        _quantize_int8_into(x.real, out[0])
        _quantize_int8_into(x.imag, out[1])
        return out
    re, im = np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
    if transfer_dtype is not None:
        import ml_dtypes  # numpy-side bfloat16 (jnp.bfloat16's np dtype)

        dt = (
            ml_dtypes.bfloat16
            if jnp.dtype(transfer_dtype) == jnp.bfloat16
            else np.dtype(jnp.dtype(transfer_dtype).name)
        )
        return np.stack([re.astype(dt), im.astype(dt)])
    return np.stack([re.astype(np.float32), im.astype(np.float32)])


def planes_to_complex(planes: jax.Array, packed_int4: bool = False) -> jax.Array:
    """Inverse of :func:`to_transfer_planes`, for use INSIDE a jit: dequant
    ``[2, ...]`` wire planes back to complex64. ``packed_int4`` unpacks the
    two-samples-per-byte wire (the caller knows its transfer dtype; the
    packed u8 array is shape-ambiguous on its own)."""
    if packed_int4:
        lo = (planes & jnp.uint8(0x0F)).astype(jnp.float32) - 8.0
        hi = (planes >> jnp.uint8(4)).astype(jnp.float32) - 8.0
        p = jnp.stack([lo, hi], axis=-1).reshape(
            planes.shape[:-1] + (2 * planes.shape[-1],)
        ) * jnp.float32(1.0 / INT4_SCALE)
        return jax.lax.complex(p[0], p[1])
    p = planes.astype(jnp.float32)
    if planes.dtype == jnp.int8:
        p = p * jnp.float32(1.0 / INT8_SCALE)
    return jax.lax.complex(p[0], p[1])


def to_device(x: np.ndarray, transfer_dtype=None) -> jax.Array:
    """numpy -> device, transferring complex data as separate I/Q planes.

    ``transfer_dtype=jnp.bfloat16`` halves and ``jnp.int8`` quarters the
    wire size of complex inputs (planes are cast back to f32 on device; int8
    is fixed-point at INT8_SCALE). The quantization floors (~45 dB bf16,
    ~42 dB int8) sit far above the modem's operating Es/N0; use for
    h2d-bandwidth-bound streaming."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        re = np.ascontiguousarray(x.real)
        im = np.ascontiguousarray(x.imag)
        if transfer_dtype is not None and jnp.dtype(transfer_dtype) == jnp.int8:
            q = lambda p: jnp.asarray(
                np.clip(np.round(p * INT8_SCALE), -127, 127).astype(np.int8)
            ).astype(jnp.float32) * jnp.float32(1.0 / INT8_SCALE)
            return jax.lax.complex(q(re), q(im))
        if transfer_dtype is not None:
            re = jnp.asarray(re.astype(transfer_dtype)).astype(jnp.float32)
            im = jnp.asarray(im.astype(transfer_dtype)).astype(jnp.float32)
            return jax.lax.complex(re, im)
        return jax.lax.complex(jnp.asarray(re), jnp.asarray(im))
    return jnp.asarray(x)
