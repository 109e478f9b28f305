"""Client-side AWS signature v4 signer.

Used by the S3 tier backend (storage/backend.py) to authenticate
against any S3-compatible endpoint.  The computation is the one the
JAX package's gateway verifies with (`s3api/auth.py`
`compute_signature_v4`), kept here with its helpers so the port needs
no server-side module.
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def derive_signing_key(secret: str, date: str, region: str,
                       service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_query(raw_query: str) -> str:
    """AWS canonical query: sorted, URI-encoded key=value pairs."""
    pairs = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
    enc = [(urllib.parse.quote(k, safe="-_.~"),
            urllib.parse.quote(v, safe="-_.~")) for k, v in pairs]
    return "&".join(f"{k}={v}" for k, v in sorted(enc))


def canonical_uri(path: str) -> str:
    # S3 canonicalizes the path with '/' kept.
    return urllib.parse.quote(urllib.parse.unquote(path), safe="/-_.~")


def compute_signature_v4(method: str, path: str, raw_query: str,
                         headers: dict[str, str], signed_headers: list[str],
                         payload_hash: str, amz_date: str, scope: str,
                         secret_key: str) -> str:
    """The exact AWS sig v4 computation."""
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n"
        for h in signed_headers)
    canonical_request = "\n".join([
        method, canonical_uri(path), canonical_query(raw_query),
        canon_headers, ";".join(signed_headers), payload_hash])
    date, region, service, _term = scope.split("/")
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        _sha256(canonical_request.encode())])
    key = derive_signing_key(secret_key, date, region, service)
    return hmac.new(key, string_to_sign.encode(),
                    hashlib.sha256).hexdigest()


def sign_request(method: str, url: str, headers: dict[str, str],
                 payload: bytes, access_key: str, secret_key: str,
                 region: str = "us-east-1",
                 payload_hash: str | None = None,
                 service: str = "s3") -> dict[str, str]:
    """Returns headers + the sig v4 Authorization set for this request.
    Pass a precomputed payload_hash to sign a streamed body without
    materializing it.  `service` scopes the credential."""
    parsed = urllib.parse.urlparse(url)
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    if payload_hash is None:
        payload_hash = hashlib.sha256(payload).hexdigest()
    out = dict(headers)
    out["Host"] = parsed.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash
    lower = {k.lower(): v for k, v in out.items()}
    signed = sorted(lower)
    sig = compute_signature_v4(
        method, parsed.path, parsed.query, lower, signed,
        payload_hash, amz_date, scope, secret_key)
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return out
