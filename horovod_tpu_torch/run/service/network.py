"""The two helpers of ``horovod_tpu/run/service/network.py`` that the
launcher and the rendezvous use: the transport's jittered backoff
(``backoff_delay``, :361-366) and the host's interface addresses
(``local_interfaces``, :1776-1809).  The rest of that module, the
HMAC-framed TCP transport of the driver and task services, comes with
the port's service layer (ROADMAP A.13b/e)."""

import random
import socket
import struct


def backoff_delay(attempt, base=0.05, cap=2.0):
    """Exponential backoff with jitter (50-100% of the exponential
    step): ranks that retry after a shared blip decorrelate instead of
    knocking again in lockstep."""
    return min(cap, base * (1 << min(attempt, 16))) * \
        (0.5 + random.random() * 0.5)


def local_interfaces():
    """{interface_name: ipv4} for every up non-loopback interface
    (``ioctl`` SIOCGIFADDR on each of ``socket.if_nameindex``); a
    hostname lookup under the pseudo-interface ``_default`` when none
    answers."""
    import fcntl

    out = {}
    try:
        ifaces = socket.if_nameindex()
    except OSError:
        ifaces = []
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _, name in ifaces:
            if name == "lo":
                continue
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", name.encode()[:15]))
                out[name] = socket.inet_ntoa(packed[20:24])
            except OSError:
                continue  # an interface without an IPv4 address
    finally:
        s.close()
    if not out:
        try:
            out["_default"] = socket.gethostbyname(socket.gethostname())
        except OSError:
            out["_default"] = "127.0.0.1"
    return out
