"""Small networking helpers shared by the runtime and multi-host train."""
from __future__ import annotations

import socket


def routable_ip() -> str:
    """Best-effort address other hosts can reach this host at.

    A UDP connect() selects the outbound interface without sending any
    packet; falls back to hostname resolution, then loopback.
    """
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        probe.connect(("8.8.8.8", 80))
        return probe.getsockname()[0]
    except OSError:
        pass
    finally:
        probe.close()
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def free_port(host: str = "") -> int:
    """A currently-free TCP port on this host (standard bind-0 probe)."""
    with socket.socket() as s:
        s.bind((host or "", 0))
        return s.getsockname()[1]
