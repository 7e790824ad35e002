"""Pluggable request authentication.

A copy of `cook_tpu/rest/auth.py` without aiohttp: an authenticator reads
only `request.headers` (the shim's `Request`, rest/http.py).  The
`gssapi` acceptor is `rest/gssapi.py`'s ctypes binding of libgssapi_krb5.

Reference: the middleware stack assembled in components.clj:267-284 picks
an authenticator — Kerberos SPNEGO (rest/spnego.clj), HTTP basic
(rest/basic_auth.clj), or the one-user dev middleware — and impersonation
wraps whichever is active.  Here the same seam is a small protocol:

    class Authenticator:
        def authenticate(self, request) -> Optional[str]   # None = denied
        def challenge(self) -> dict                        # 401 headers

The composite dev default (basic auth, then the X-Cook-Requesting-User
header, then "anonymous") preserves the development behavior; production
configs select `spnego` or `basic` explicitly, at which point requests
without valid credentials get a 401 with the proper challenge header.

The SPNEGO implementation mirrors spnego.clj's shape: parse the
`Authorization: Negotiate <token>` header, hand the token to a GSS
acceptor, answer 401 + `WWW-Authenticate: Negotiate` when absent or
rejected.  The GSS acceptor itself is injectable (`gss_accept`): in
environments without a KDC the default acceptor rejects everything, which
is the correct closed-by-default posture — the seam and its negative
paths are real, the Kerberos mechanics plug in at deploy time.
"""
from __future__ import annotations

import base64
import binascii
from typing import Callable, Optional, Protocol, Sequence, runtime_checkable


@runtime_checkable
class Authenticator(Protocol):
    def authenticate(self, request) -> Optional[str]: ...

    def challenge(self) -> dict: ...


class BasicAuthenticator:
    """HTTP basic auth (rest/basic_auth.clj): the reference trusts the
    username and ignores the password (it fronts Cook with trusted
    proxies); an optional verifier callable tightens that."""

    def __init__(self, verify: Optional[Callable[[str, str], bool]] = None):
        self.verify = verify

    def authenticate(self, request) -> Optional[str]:
        header = request.headers.get("Authorization", "")
        if not header.startswith("Basic "):
            return None
        try:
            decoded = base64.b64decode(header[6:]).decode()
            user, _, password = decoded.partition(":")
        except (binascii.Error, UnicodeDecodeError, ValueError):
            # b64decode raises plain ValueError on non-ASCII input
            return None
        if not user:
            return None
        if self.verify is not None and not self.verify(user, password):
            return None
        return user

    def challenge(self) -> dict:
        return {"WWW-Authenticate": 'Basic realm="cook"'}


class DevHeaderAuthenticator:
    """The one-user dev middleware: trust X-Cook-Requesting-User."""

    def __init__(self, default_user: str = "anonymous"):
        self.default_user = default_user

    def authenticate(self, request) -> Optional[str]:
        return (request.headers.get("X-Cook-Requesting-User")
                or self.default_user)

    def challenge(self) -> dict:
        return {}


class SpnegoAuthenticator:
    """Kerberos SPNEGO (rest/spnego.clj): Negotiate tokens accepted via
    an injectable GSS acceptor `gss_accept(token_bytes) -> principal or
    None`; the principal's primary component becomes the user."""

    def __init__(self, gss_accept: Optional[Callable[[bytes],
                                                     Optional[str]]] = None):
        # closed by default: no acceptor = nobody authenticates
        self.gss_accept = gss_accept

    def authenticate(self, request) -> Optional[str]:
        header = request.headers.get("Authorization", "")
        if not header.startswith("Negotiate "):
            return None
        try:
            token = base64.b64decode(header[len("Negotiate "):])
        except (binascii.Error, ValueError):
            return None
        if self.gss_accept is None:
            return None
        principal = self.gss_accept(token)
        if not principal:
            return None
        # alice/admin@EXAMPLE.COM -> alice (spnego.clj principal parse)
        return principal.split("@", 1)[0].split("/", 1)[0]

    def challenge(self) -> dict:
        return {"WWW-Authenticate": "Negotiate"}


class CompositeAuthenticator:
    """First authenticator to produce a user wins; the challenge headers
    of every member are merged into the 401."""

    def __init__(self, members: Sequence):
        self.members = list(members)

    def authenticate(self, request) -> Optional[str]:
        for member in self.members:
            user = member.authenticate(request)
            if user:
                return user
        return None

    def challenge(self) -> dict:
        # schemes share the WWW-Authenticate key; HTTP allows multiple
        # challenges comma-joined in one header value — dropping all but
        # the last would make e.g. SPNEGO unreachable behind a composite
        # (Negotiate clients only send tokens after seeing Negotiate)
        values: dict[str, list[str]] = {}
        for member in self.members:
            for key, value in member.challenge().items():
                bucket = values.setdefault(key, [])
                if value not in bucket:
                    bucket.append(value)
        return {key: ", ".join(vals) for key, vals in values.items()}


def dev_default_authenticator() -> CompositeAuthenticator:
    """Basic auth, then the dev header (which falls back to anonymous) —
    the permissive development stack, never returns None."""
    return CompositeAuthenticator([BasicAuthenticator(),
                                   DevHeaderAuthenticator()])


def authenticator_from_config(conf: dict):
    """Build the configured authenticator
    ({"kind": "dev"|"basic"|"spnego"|"composite", ...})."""
    kind = conf.get("kind", "dev")
    if kind == "dev":
        return dev_default_authenticator()
    if kind == "basic":
        verify = None
        if conf.get("verify"):
            # dotted path to a callable(user, password) -> bool, same
            # plugin mechanism as spnego's gss_accept
            from cook_tpu_torch.scheduler.plugins import load_plugin

            verify = load_plugin(conf["verify"])
            if not callable(verify):
                verify = verify.verify
        return BasicAuthenticator(verify=verify)
    if kind == "spnego":
        acceptor = None
        if conf.get("gss_accept"):
            from cook_tpu_torch.scheduler.plugins import load_plugin

            acceptor = load_plugin(conf["gss_accept"])
            if not callable(acceptor):
                acceptor = acceptor.gss_accept
        elif conf.get("gssapi"):
            # real Kerberos via libgssapi_krb5 (KRB5_KTNAME supplies the
            # keytab in deployment); None when the library is absent,
            # which keeps the closed-by-default posture
            from cook_tpu_torch.rest.gssapi import make_gssapi_acceptor

            acceptor = make_gssapi_acceptor(
                libname=conf.get("gssapi_lib") or None)
        return SpnegoAuthenticator(gss_accept=acceptor)
    if kind == "composite":
        return CompositeAuthenticator(
            [authenticator_from_config(m) for m in conf.get("members", [])])
    raise ValueError(f"unknown authenticator kind {kind!r}")
