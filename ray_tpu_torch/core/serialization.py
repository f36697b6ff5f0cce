"""Value serialization for the object store (counterpart of
ray_tpu/core/serialization.py).

Reference parity: python/ray/_private/serialization.py — cloudpickle for
arbitrary Python, pickle protocol 5 out-of-band buffers for zero-copy numpy.

Wire format of a sealed object:
    [u32 meta_len][meta pickle][u32 nbufs][u64 len_i ... aligned buffers]

Buffers are 64-byte aligned inside the payload so readers can map numpy
arrays directly onto shared memory with no copy.

`torch.Tensor`s take the same out-of-band path as numpy arrays (the
counterpart of the reference turning a `jax.Array` into numpy): a CPU
tensor's storage becomes one out-of-band buffer with no copy, and the
reader's tensor aliases the shared memory, as a numpy array does: an
in-place op on it rewrites the object for every reader, so a consumer
that mutates clones first. A small object held inline as bytes is
copied on read instead (a numpy array there is read-only). A CUDA
tensor is copied to the host once. The reader rebuilds a tensor that
came from a card on its own default device: the card in a process that
holds a GPU (CUDA_VISIBLE_DEVICES names one and CUDA is available), the
CPU otherwise. torch's own pickling would put the storage in-band and,
for a CUDA tensor, raise in a reader without a GPU.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import sys
from typing import Any, List, Tuple

import cloudpickle

ALIGN = 64


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def _holds_gpu() -> bool:
    """This process may use a card: CUDA_VISIBLE_DEVICES (when set) names
    one and CUDA is available. A worker without GPU resources runs with
    the variable empty, so this never initialises CUDA there."""
    if os.environ.get("CUDA_VISIBLE_DEVICES", None) == "":
        return False
    import torch  # noqa: PLC0415
    return torch.cuda.is_available()


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    from_cuda: bool, parameter: bool = False):
    """Inverse of _TensorPickler's reduction: a tensor over `buf` (a view
    of the reader's shared memory for an out-of-band buffer), moved to
    the card when it came from one and this process holds a GPU; an
    nn.Parameter again where it was one."""
    import torch  # noqa: PLC0415
    dt = getattr(torch, dtype)
    mv = memoryview(buf)
    if not mv.nbytes:
        flat = torch.empty(0, dtype=torch.uint8)
    elif mv.readonly:
        # an object held inline as bytes: torch has no read-only tensor,
        # so the reader gets a copy and the stored bytes never change
        flat = torch.frombuffer(bytearray(mv), dtype=torch.uint8)
    else:
        # shared memory: the tensor aliases it, as a numpy array does
        flat = torch.frombuffer(mv, dtype=torch.uint8)
    t = flat.view(dt).reshape(shape)
    if from_cuda and _holds_gpu():
        t = t.to("cuda")
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    if requires_grad:
        t.requires_grad_(True)
    return t


class _TensorPickler(cloudpickle.CloudPickler):
    """cloudpickle, with dense strided torch.Tensors reduced to one
    out-of-band byte buffer of their (host) storage."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) in (torch.Tensor,
                                                 torch.nn.Parameter)
                and obj.layout == torch.strided
                and obj.device.type in ("cpu", "cuda")
                and not obj.is_quantized):
            t = obj.detach()
            from_cuda = t.device.type == "cuda"
            host = t.to("cpu").contiguous()
            raw = host.reshape(-1).view(torch.uint8).numpy()
            return (_rebuild_tensor,
                    (pickle.PickleBuffer(raw),
                     str(host.dtype).split(".", 1)[1], tuple(host.shape),
                     bool(obj.requires_grad), from_cuda,
                     type(obj) is torch.nn.Parameter))
        return super().reducer_override(obj)


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize to (meta, out_of_band_buffers).

    numpy arrays (and anything implementing __reduce_ex__ with protocol 5
    buffer support) and torch tensors ship their payload out-of-band.
    """
    buffers: List[pickle.PickleBuffer] = []
    if "torch" not in sys.modules:
        meta = cloudpickle.dumps(value, protocol=5,
                                 buffer_callback=buffers.append)
        return meta, buffers
    f = io.BytesIO()
    _TensorPickler(f, protocol=5, buffer_callback=buffers.append).dump(value)
    return f.getvalue(), buffers


def pack(value: Any) -> bytes:
    """Serialize into a single contiguous payload (small-object path)."""
    meta, bufs = serialize(value)
    return pack_parts(meta, bufs)


def pack_parts(meta: bytes, bufs: List[pickle.PickleBuffer]) -> bytes:
    raws = [b.raw() for b in bufs]
    header = bytearray()
    header += struct.pack("<I", len(meta))
    header += meta
    header += struct.pack("<I", len(raws))
    for r in raws:
        header += struct.pack("<Q", r.nbytes)
    out = bytearray(header)
    for r in raws:
        pad = _align(len(out)) - len(out)
        out += b"\x00" * pad
        out += r
    return bytes(out)


def packed_size(meta: bytes, bufs: List[pickle.PickleBuffer]) -> int:
    n = 4 + len(meta) + 4 + 8 * len(bufs)
    for b in bufs:
        n = _align(n) + b.raw().nbytes
    return n


def pack_into(mv: memoryview, meta: bytes, bufs: List[pickle.PickleBuffer]) -> int:
    """Write the wire format into a writable memoryview (shm path). Returns
    bytes written."""
    off = 0
    mv[off:off + 4] = struct.pack("<I", len(meta)); off += 4
    mv[off:off + len(meta)] = meta; off += len(meta)
    raws = [b.raw() for b in bufs]
    mv[off:off + 4] = struct.pack("<I", len(raws)); off += 4
    for r in raws:
        mv[off:off + 8] = struct.pack("<Q", r.nbytes); off += 8
    for r in raws:
        aligned = _align(off)
        if aligned != off:
            mv[off:aligned] = b"\x00" * (aligned - off)
            off = aligned
        mv[off:off + r.nbytes] = r
        off += r.nbytes
    return off


def unpack(payload) -> Any:
    """Deserialize from bytes or a memoryview.

    When given a memoryview over shared memory, numpy buffers alias the shm
    pages (zero-copy); callers must keep the segment mapped while the value
    lives. bytes input always owns its data.
    """
    mv = memoryview(payload)
    off = 0
    (meta_len,) = struct.unpack_from("<I", mv, off); off += 4
    meta = bytes(mv[off:off + meta_len]); off += meta_len
    (nbufs,) = struct.unpack_from("<I", mv, off); off += 4
    sizes = []
    for _ in range(nbufs):
        (sz,) = struct.unpack_from("<Q", mv, off); off += 8
        sizes.append(sz)
    bufs = []
    for sz in sizes:
        aligned = _align(off)
        bufs.append(mv[aligned:aligned + sz])
        off = aligned + sz
    return pickle.loads(meta, buffers=bufs)


def dumps_call(obj: Any) -> bytes:
    """Serialize task functions / actor classes by value (cloudpickle)."""
    return cloudpickle.dumps(obj)


def loads_call(data: bytes) -> Any:
    return cloudpickle.loads(data)
