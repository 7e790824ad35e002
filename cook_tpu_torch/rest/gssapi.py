"""Real GSSAPI acceptor for SPNEGO, bound via ctypes to libgssapi_krb5.

A copy of `cook_tpu/rest/gssapi.py` (standard library only).

The reference authenticates with Kerberos SPNEGO (rest/spnego.clj), with
the GSS mechanics provided by the JVM.  Here the same single-leg accept is
done against MIT Kerberos' C library directly: `gss_accept_sec_context`
with the default acceptor credential (honours KRB5_KTNAME for the keytab),
then `gss_display_name` for the client principal.

Without a KDC or a keytab, every token is rejected with a GSS error —
which is the correct closed-by-default posture; in deployment, pointing
KRB5_KTNAME at the service keytab is the only configuration needed.  Multi-leg negotiation
(GSS_S_CONTINUE_NEEDED) is not supported: Kerberos-backed SPNEGO completes
in one leg, matching the reference's request-scoped accept.

Wire-up: `{"auth": {"kind": "spnego", "gssapi": true}}` or inject
`make_gssapi_acceptor()` as the `gss_accept` callable.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import logging
from typing import Callable, Optional

log = logging.getLogger(__name__)

GSS_S_COMPLETE = 0
GSS_S_CONTINUE_NEEDED = 1


class _GssBuffer(ctypes.Structure):
    _fields_ = [("length", ctypes.c_size_t), ("value", ctypes.c_void_p)]


def _load_lib(libname: Optional[str] = None):
    names = ([libname] if libname else
             ["libgssapi_krb5.so.2", "libgssapi_krb5.so",
              ctypes.util.find_library("gssapi_krb5")])
    for name in names:
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def make_gssapi_acceptor(
    libname: Optional[str] = None,
) -> Optional[Callable[[bytes], Optional[str]]]:
    """Build `gss_accept(token) -> principal or None` over libgssapi_krb5.

    Returns None when the library cannot be loaded (caller falls back to
    the closed-by-default acceptor)."""
    lib = _load_lib(libname)
    if lib is None:
        log.warning("libgssapi_krb5 not found; SPNEGO stays closed")
        return None

    u32 = ctypes.c_uint32
    ptr = ctypes.c_void_p
    lib.gss_accept_sec_context.restype = u32
    lib.gss_display_name.restype = u32
    lib.gss_release_buffer.restype = u32
    lib.gss_release_name.restype = u32
    lib.gss_delete_sec_context.restype = u32

    def gss_accept(token: bytes) -> Optional[str]:
        minor = u32(0)
        context = ptr(None)
        src_name = ptr(None)
        mech_type = ptr(None)
        output = _GssBuffer(0, None)
        flags = u32(0)
        time_rec = u32(0)
        buf = ctypes.create_string_buffer(token, len(token))
        input_token = _GssBuffer(len(token),
                                 ctypes.cast(buf, ctypes.c_void_p))
        try:
            major = lib.gss_accept_sec_context(
                ctypes.byref(minor), ctypes.byref(context),
                None,                      # acceptor cred: default (keytab)
                ctypes.byref(input_token),
                None,                      # no channel bindings
                ctypes.byref(src_name), ctypes.byref(mech_type),
                ctypes.byref(output), ctypes.byref(flags),
                ctypes.byref(time_rec),
                None,   # delegated cred unused: NULL avoids leaking one
            )
            accept_minor = minor.value
            if output.value:
                lib.gss_release_buffer(ctypes.byref(minor),
                                       ctypes.byref(output))
            if major != GSS_S_COMPLETE:
                # includes CONTINUE_NEEDED (multi-leg unsupported) and all
                # failures (no keytab, clock skew, bad token...)
                log.debug("gss_accept_sec_context major=0x%x minor=%d",
                          major, accept_minor)
                return None
            name_buf = _GssBuffer(0, None)
            major = lib.gss_display_name(ctypes.byref(minor), src_name,
                                         ctypes.byref(name_buf), None)
            if major != GSS_S_COMPLETE or not name_buf.value:
                return None
            principal = ctypes.string_at(
                name_buf.value, name_buf.length).decode("utf-8", "replace")
            lib.gss_release_buffer(ctypes.byref(minor),
                                   ctypes.byref(name_buf))
            return principal
        finally:
            if src_name.value:
                lib.gss_release_name(ctypes.byref(minor),
                                     ctypes.byref(src_name))
            if context.value:
                lib.gss_delete_sec_context(ctypes.byref(minor),
                                           ctypes.byref(context), None)

    return gss_accept
