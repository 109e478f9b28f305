"""Write-access JWT + request guard + TLS plane (reference:
weed/security/jwt.go:21, guard.go:43-65, tls.go).

The reference guards volume-server writes with an HS256 JWT minted by the
master (claim `fid` binds the token to one file id) when `jwt.signing.key`
is set in security.toml, plus an IP white list.  Same scheme here, using
only the stdlib: compact JWS, HS256, `exp` + `fid` claims.

TLS follows security.toml's `[grpc.<component>]` sections exactly like
the reference (tls.go LoadServerTLS/LoadClientTLS): each server role
loads `grpc.<role>.cert/key` and requires client certificates signed by
`grpc.ca` (mutual TLS, RequireAndVerifyClientCert); clients present
`grpc.client.cert/key`.  Our transport is the pooled HTTP RPC plane, so
the contexts install into cluster.rpc (JsonHttpServer(ssl_context=...) +
set_client_ssl_context), and every inter-server URL is upgraded to
https by the transport — addresses stay `host:port`, the scheme is the
dial option, as in grpc_client_server.go.  One deliberate improvement:
the reference's client sets InsecureSkipVerify (tls.go:70); ours
verifies the server chain against the same CA.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JwtError(Exception):
    pass


def gen_jwt(signing_key: str, expires_seconds: int, fid: str) -> str:
    """Mint the write token the master attaches to Assign responses
    (security/jwt.go GenJwt)."""
    if not signing_key:
        return ""
    header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    claims = {"fid": fid}
    if expires_seconds:
        claims["exp"] = int(time.time()) + expires_seconds
    payload = _b64(json.dumps(claims).encode())
    msg = f"{header}.{payload}".encode()
    sig = hmac.new(signing_key.encode(), msg, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64(sig)}"


def decode_jwt(signing_key: str, token: str) -> dict:
    """Verify signature + expiry, return claims (security/jwt.go DecodeJwt)."""
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise JwtError("malformed token") from None
    msg = f"{header}.{payload}".encode()
    want = hmac.new(signing_key.encode(), msg, hashlib.sha256).digest()
    if not hmac.compare_digest(want, _unb64(sig)):
        raise JwtError("bad signature")
    claims = json.loads(_unb64(payload))
    if "exp" in claims and claims["exp"] < time.time():
        raise JwtError("token expired")
    return claims


class Guard:
    """Per-request access check: IP white list OR valid JWT
    (security/guard.go WhiteList/Secure)."""

    def __init__(self, white_list: list[str] | None = None,
                 signing_key: str = "", expires_seconds: int = 10):
        self.white_list = set(white_list or [])
        self.signing_key = signing_key
        self.expires_seconds = expires_seconds

    @property
    def is_active(self) -> bool:
        return bool(self.white_list or self.signing_key)

    def check_white_list(self, peer_ip: str) -> bool:
        return not self.white_list or peer_ip in self.white_list

    def check_jwt(self, token: str, fid: str) -> None:
        """Raises JwtError unless the token authorizes writing `fid`."""
        if not self.signing_key:
            return
        if not token:
            raise JwtError("jwt required")
        claims = decode_jwt(self.signing_key, token)
        claimed = claims.get("fid", "")
        # The reference accepts a token minted for the base fid on its
        # _suffix variants (jwt.go: strips after '_').
        if claimed and claimed != fid and not fid.startswith(claimed + "_"):
            raise JwtError(f"token fid {claimed!r} != {fid!r}")


# -- TLS plane (security/tls.go) ---------------------------------------------


def tls_server_context(cert_file: str, key_file: str, ca_file: str = "",
                       require_client_cert: bool = False):
    """Server-side context: serve the given cert; with
    require_client_cert, demand a CA-signed client certificate — the
    reference's RequireAndVerifyClientCert mutual TLS (tls.go:33-38)."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file and require_client_cert:
        ctx.load_verify_locations(cafile=ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def tls_client_context(cert_file: str = "", key_file: str = "",
                       ca_file: str = ""):
    """Client-side context: present cert/key for mTLS and verify the
    server chain against the CA.  Hostname checking is off because
    cluster addresses are bare `host:port` (the reference skips server
    verification entirely; we keep chain verification)."""
    import ssl
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if ca_file:
        ctx.load_verify_locations(cafile=ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if cert_file and key_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx


def load_server_tls(cfg, component: str):
    """security.toml `[grpc.<component>]` -> server SSLContext, or None
    when no cert/key is configured (tls.go LoadServerTLS: missing config
    degrades to plaintext).

    Client-certificate policy: the reference runs mutual TLS on a
    dedicated inter-server gRPC port while the public HTTP ports stay
    separate; our servers expose ONE port serving both planes, so
    demanding client certs by default would lock standard end-user
    clients (aws-cli, curl, davfs2) out of the gateways.  Default is
    therefore server-auth TLS; set `client_auth = "require"` per
    component to get the reference's RequireAndVerifyClientCert
    behavior where the port is cluster-internal."""
    parsed = server_tls_config(cfg, component)
    if parsed is None:
        return None
    cert, key, ca, mode = parsed
    return tls_server_context(cert, key, ca,
                              require_client_cert=mode == "require")


def server_tls_config(cfg, component: str):
    """Parse + validate `[grpc.<component>]` -> (cert, key, ca, mode)
    or None — the ONE config reader behind both the HTTPS and gRPC
    planes, so a client_auth typo fails loudly on both."""
    if cfg is None:
        return None
    cert = cfg.get_string(f"grpc.{component}.cert")
    key = cfg.get_string(f"grpc.{component}.key")
    if not cert or not key:
        return None
    ca = cfg.get_string(f"grpc.{component}.ca") or cfg.get_string("grpc.ca")
    mode = cfg.get_string(f"grpc.{component}.client_auth", "none").lower()
    if mode not in ("none", "require"):
        raise ValueError(
            f"grpc.{component}.client_auth must be 'none' or 'require', "
            f"got {mode!r}")
    if mode == "require" and not ca:
        raise ValueError(
            f"grpc.{component}.client_auth = 'require' needs grpc.ca")
    return cert, key, ca, mode


def load_client_tls(cfg, component: str = "client"):
    """security.toml `[grpc.client]` -> client SSLContext, or None.
    Like the reference (tls.go:48-51), all of cert/key/ca must be set."""
    if cfg is None:
        return None
    cert = cfg.get_string(f"grpc.{component}.cert")
    key = cfg.get_string(f"grpc.{component}.key")
    ca = cfg.get_string(f"grpc.{component}.ca") or cfg.get_string("grpc.ca")
    if not cert or not key or not ca:
        return None
    return tls_client_context(cert, key, ca)


_security_cfg = None


def security_configuration():
    """The process-wide parsed security.toml, loaded once and shared by
    the CLI dispatcher and every server command — one source of truth
    (the reference loads it once via viper at command start)."""
    global _security_cfg
    if _security_cfg is None:
        from .config import load_configuration
        _security_cfg = load_configuration("security")
    return _security_cfg


def install_cluster_tls(cfg) -> bool:
    """Wire the client half of the TLS plane process-wide: install the
    `[grpc.client]` context into the RPC transport and upgrade every
    inter-server http:// URL to https.  Returns True when TLS is on."""
    ctx = load_client_tls(cfg)
    if ctx is None:
        return False
    from ..cluster import rpc
    rpc.set_client_ssl_context(ctx, force_https=True)
    return True


def grpc_server_credentials(cfg, component: str):
    """security.toml `[grpc.<component>]` -> grpc.ServerCredentials, or
    None when no cert/key is configured — the same parsed/validated
    config as the HTTPS plane (server_tls_config), so both planes of
    one component share one TLS story."""
    parsed = server_tls_config(cfg, component)
    if parsed is None:
        return None
    cert, key, ca, mode = parsed
    import grpc
    with open(key, "rb") as f:
        key_pem = f.read()
    with open(cert, "rb") as f:
        cert_pem = f.read()
    root = None
    if ca:
        with open(ca, "rb") as f:
            root = f.read()
    return grpc.ssl_server_credentials(
        [(key_pem, cert_pem)], root_certificates=root,
        require_client_auth=(mode == "require"))
