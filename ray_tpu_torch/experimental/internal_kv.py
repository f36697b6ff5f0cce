"""Cluster-wide internal key-value store.

Reference parity: python/ray/experimental/internal_kv.py (the GCS KV
used by runtime_env, serve, jobs...). Keys/values are bytes; optional
namespace isolates users. Works from the driver (directly against the
GCS table) and from workers (a sys.kv report_sync round-trip).
"""
from __future__ import annotations

from typing import List, Optional, Union

from ..core import runtime as runtime_mod


def _key(ns: Optional[Union[str, bytes]],
         key: Union[str, bytes]) -> str:
    if isinstance(key, bytes):
        key = key.decode()
    if ns:
        if isinstance(ns, bytes):
            ns = ns.decode()
        return f"{ns}\x00{key}"
    return f"\x00{key}"


def _as_bytes(v: Union[str, bytes]) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


def _call(op: str, *args):
    rt = runtime_mod.get_runtime()
    if rt.is_driver:
        return rt._kv_op(op, *args)
    return rt.report_sync("sys.kv", (op, *args), timeout=10.0)


def _internal_kv_initialized() -> bool:
    return runtime_mod.runtime_initialized()


def _internal_kv_put(key, value, overwrite: bool = True,
                     namespace=None) -> bool:
    """Returns True iff the key already existed."""
    return _call("put", _key(namespace, key), _as_bytes(value), overwrite)


def _internal_kv_get(key, namespace=None) -> Optional[bytes]:
    return _call("get", _key(namespace, key))


def _internal_kv_exists(key, namespace=None) -> bool:
    return _call("exists", _key(namespace, key))


def _internal_kv_del(key, del_by_prefix: bool = False,
                     namespace=None) -> int:
    return _call("del", _key(namespace, key), del_by_prefix)


def _internal_kv_list(prefix, namespace=None) -> List[bytes]:
    return _call("list", _key(namespace, prefix))


# public aliases (the reference keeps the underscore names; both work)
kv_put = _internal_kv_put
kv_get = _internal_kv_get
kv_del = _internal_kv_del
kv_list = _internal_kv_list
kv_exists = _internal_kv_exists
