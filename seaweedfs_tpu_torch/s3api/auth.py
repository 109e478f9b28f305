"""AWS signature verification + identity/action access control.

Reference: weed/s3api/auth_signature_v4.go (doesSignatureMatch),
auth_signature_v2.go (header + presigned v2, HMAC-SHA1 over the
canonical string), s3api/policy/ (POST-policy form signatures), and
auth_credentials.go (IdentityAccessManagement, per-identity actions
Read/Write/Admin, anonymous when no identities are configured).

Supported: v4 header auth (what SDKs send by default), v4 presigned
URLs, v2 header auth, v2 presigned URLs, and POST-policy form auth in
both v2 and v4 flavors.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse
from dataclasses import dataclass, field

# The SigV4 computation lives in sigv4.py (which the storage tier's
# signer needs without the gateway); the verifier here takes it from
# there, so signer and verifier cannot drift.
from .sigv4 import (_hmac, _sha256, canonical_query,  # noqa: F401
                    canonical_uri, compute_signature_v4, derive_signing_key)

ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"
ACTION_ADMIN = "Admin"


class AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code = code
        self.status = status


@dataclass
class Identity:
    name: str
    access_key: str
    secret_key: str
    actions: list[str] = field(default_factory=lambda: [ACTION_ADMIN])

    def allows(self, action: str, bucket: str) -> bool:
        for a in self.actions:
            if a == ACTION_ADMIN:
                return True
            base, _, target = a.partition(":")
            if base != action:
                continue
            if not target or target == bucket:
                return True
        return False


# Subresources that participate in the v2 canonical resource
# (auth_signature_v2.go resourceList — alphabetically sorted).
RESOURCE_LIST = [
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type",
    "response-expires", "torrent", "uploadId", "uploads", "versionId",
    "versioning", "versions", "website",
]


def identities_from_dict(cfg: dict) -> list[Identity]:
    """Parse the reference's S3 identities config shape
    (auth_credentials.go: {"identities": [{name, credentials:
    [{accessKey, secretKey}], actions}]})."""
    out = []
    for ident in cfg.get("identities", []):
        cred = (ident.get("credentials") or [{}])[0]
        out.append(Identity(name=ident.get("name", ""),
                            access_key=cred.get("accessKey", ""),
                            secret_key=cred.get("secretKey", ""),
                            actions=ident.get("actions", [ACTION_ADMIN])))
    return out


def signature_v2(secret_key: str, string_to_sign: str) -> str:
    """base64(HMAC-SHA1) — the v2 primitive (calculateSignatureV2)."""
    return base64.b64encode(hmac.new(
        secret_key.encode(), string_to_sign.encode(),
        hashlib.sha1).digest()).decode()


def canonical_resource_v2(path: str, raw_query: str) -> str:
    """Path + whitelisted subresources, sorted (CanonicalizedResource)."""
    pairs = urllib.parse.parse_qsl(raw_query, keep_blank_values=True)
    sub = [f"{k}={v}" if v else k
           for k, v in sorted(pairs) if k in RESOURCE_LIST]
    return path + (("?" + "&".join(sub)) if sub else "")


def canonical_string_v2(method: str, path: str, raw_query: str,
                        headers: dict[str, str], date_field: str) -> str:
    """The v2 StringToSign (signatureV2/presignatureV2): method,
    content-md5, content-type, date (or Expires for presigned, or ""
    when x-amz-date supersedes), x-amz-* headers, canonical resource."""
    amz = sorted((k.lower().strip(), " ".join(v.split()))
                 for k, v in headers.items()
                 if k.lower().startswith("x-amz-"))
    canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
    return "\n".join([
        method,
        headers.get("content-md5", ""),
        headers.get("content-type", ""),
        date_field,
    ]) + "\n" + canon_amz + canonical_resource_v2(path, raw_query)


class IdentityAccessManagement:
    """Identity registry + request authentication (auth_credentials.go)."""

    def __init__(self, identities: list[Identity] | None = None):
        self.identities = {i.access_key: i for i in (identities or [])}
        # Set by a filer-backed gateway that could not reach its IAM
        # config: deny everything rather than default to anonymous
        # all-access.
        self.fail_closed = False

    def replace(self, identities: list[Identity]) -> None:
        """Atomically swap the identity set (filer-backed IAM reload)."""
        self.identities = {i.access_key: i for i in identities}

    @property
    def enabled(self) -> bool:
        return bool(self.identities)

    def authenticate(self, method: str, path: str, raw_query: str,
                     headers: dict[str, str],
                     body: bytes | None) -> Identity | None:
        """Verify the v4 Authorization header; returns the Identity.
        With no identities configured every request is anonymous-admin
        (the reference's default when no config is present).

        body=None means the payload is being streamed and is not
        available for hashing: the signature is computed over the
        DECLARED x-amz-content-sha256 (exactly what the reference does
        — auth_signature_v4.go signs the header value and never
        re-hashes the stream); the recompute cross-check below only
        runs when the bytes are in hand."""
        if self.fail_closed:
            raise AuthError("ServiceUnavailable",
                            "IAM configuration unavailable", 503)
        if not self.enabled:
            return None
        auth = headers.get("authorization", "")
        if auth.startswith("AWS4-HMAC-SHA256 "):
            return self._auth_v4_header(method, path, raw_query, headers,
                                        body, auth)
        if auth.startswith("AWS "):
            return self._auth_v2_header(method, path, raw_query, headers,
                                        auth)
        q = dict(urllib.parse.parse_qsl(raw_query,
                                        keep_blank_values=True))
        if q.get("X-Amz-Algorithm") == "AWS4-HMAC-SHA256":
            return self._auth_v4_presigned(method, path, raw_query,
                                           headers, q)
        if "Signature" in q and "AWSAccessKeyId" in q and "Expires" in q:
            return self._auth_v2_presigned(method, path, raw_query,
                                           headers, q)
        raise AuthError("AccessDenied", "no valid authentication")

    def _lookup(self, access_key: str) -> Identity:
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}")
        return identity

    def _auth_v4_header(self, method, path, raw_query, headers, body,
                        auth) -> Identity:
        parts = {}
        for kv in auth[len("AWS4-HMAC-SHA256 "):].split(","):
            k, _, v = kv.strip().partition("=")
            parts[k] = v
        try:
            cred = parts["Credential"]
            signed_headers = parts["SignedHeaders"].split(";")
            signature = parts["Signature"]
        except KeyError as e:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"missing {e}") from None
        access_key, _, scope = cred.partition("/")
        identity = self.identities.get(access_key)
        if identity is None:
            raise AuthError("InvalidAccessKeyId",
                            f"unknown access key {access_key}")
        amz_date = headers.get("x-amz-date", "")
        self._check_date(amz_date, scope)
        payload_hash = headers.get("x-amz-content-sha256") or \
            _sha256(body or b"")
        if payload_hash == "UNSIGNED-PAYLOAD":
            pass
        elif payload_hash.startswith("STREAMING-"):
            # aws-chunked uploads: trust the seed signature's presence
            # (chunk signature verification not implemented).
            pass
        elif body is not None and \
                headers.get("x-amz-content-sha256") and \
                _sha256(body) != payload_hash:
            raise AuthError("XAmzContentSHA256Mismatch",
                            "payload hash mismatch", 400)
        expect = compute_signature_v4(
            method, path, raw_query, headers, signed_headers,
            payload_hash, amz_date, scope, identity.secret_key)
        if not hmac.compare_digest(expect, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "signature mismatch")
        return identity

    def _auth_v2_header(self, method, path, raw_query, headers,
                        auth) -> Identity:
        """`Authorization: AWS <access>:<sig>` (doesSignV2Match)."""
        access_key, _, signature = auth[4:].strip().partition(":")
        if not signature:
            raise AuthError("AuthorizationHeaderMalformed",
                            "v2 header needs AWS access:signature")
        identity = self._lookup(access_key)
        # When x-amz-date is present it supersedes Date, whose slot in
        # the string-to-sign becomes empty (the spec's replacement
        # rule).
        date_field = "" if "x-amz-date" in headers \
            else headers.get("date", "")
        expect = signature_v2(
            identity.secret_key,
            canonical_string_v2(method, path, raw_query, headers,
                                date_field))
        if not hmac.compare_digest(expect, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "v2 signature mismatch")
        return identity

    def _auth_v2_presigned(self, method, path, raw_query, headers,
                           q) -> Identity:
        """?AWSAccessKeyId=&Expires=&Signature= presigned URLs
        (doesPresignV2SignatureMatch)."""
        identity = self._lookup(q["AWSAccessKeyId"])
        try:
            expires = int(q["Expires"])
        except ValueError:
            raise AuthError("AccessDenied",
                            "malformed Expires", 400) from None
        if time.time() > expires:
            raise AuthError("AccessDenied", "request has expired")
        # Presigned v2 signs Expires in the Date slot and never signs
        # the auth params themselves.
        expect = signature_v2(
            identity.secret_key,
            canonical_string_v2(method, path, raw_query,
                                {k: v for k, v in headers.items()
                                 if k.lower() != "date"},
                                str(expires)))
        if not hmac.compare_digest(expect, q["Signature"]):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned v2 signature mismatch")
        return identity

    def _auth_v4_presigned(self, method, path, raw_query, headers,
                           q) -> Identity:
        """?X-Amz-Algorithm=AWS4-HMAC-SHA256 presigned URLs: the
        canonical query is every parameter except X-Amz-Signature and
        the payload is UNSIGNED (auth_signature_v4.go presigned)."""
        try:
            cred = q["X-Amz-Credential"]
            amz_date = q["X-Amz-Date"]
            signature = q["X-Amz-Signature"]
            signed_headers = q["X-Amz-SignedHeaders"].split(";")
        except KeyError as e:
            raise AuthError("AuthorizationQueryParametersError",
                            f"missing {e}", 400) from None
        access_key, _, scope = cred.partition("/")
        identity = self._lookup(access_key)
        # Unlike header auth, presigned URLs are MEANT to be used long
        # after signing: X-Amz-Expires governs their age (the 15-minute
        # skew window applies only to future-dating).
        import calendar
        try:
            t0 = calendar.timegm(time.strptime(amz_date,
                                               "%Y%m%dT%H%M%SZ"))
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            f"bad X-Amz-Date {amz_date!r}", 400) from None
        if scope.split("/", 1)[0] != amz_date[:8]:
            raise AuthError("AuthorizationQueryParametersError",
                            "credential scope date does not match "
                            "X-Amz-Date", 400)
        if t0 > time.time() + 15 * 60:
            raise AuthError("AccessDenied", "request is future-dated")
        try:
            expires = int(q.get("X-Amz-Expires", "604800"))
        except ValueError:
            raise AuthError("AuthorizationQueryParametersError",
                            "malformed X-Amz-Expires", 400) from None
        if time.time() > t0 + expires:
            raise AuthError("AccessDenied", "request has expired")
        filtered = urllib.parse.urlencode(
            [(k, v) for k, v in urllib.parse.parse_qsl(
                raw_query, keep_blank_values=True)
             if k != "X-Amz-Signature"])
        expect = compute_signature_v4(
            method, path, filtered, headers, signed_headers,
            "UNSIGNED-PAYLOAD", amz_date, scope, identity.secret_key)
        if not hmac.compare_digest(expect, signature):
            raise AuthError("SignatureDoesNotMatch",
                            "presigned v4 signature mismatch")
        return identity

    def authenticate_policy(self, form: dict[str, str]) -> Identity | None:
        """POST-policy form auth, v2 (AWSAccessKeyId+Signature over the
        base64 policy, doesPolicySignatureV2Match) or v4
        (X-Amz-Signature with the policy as the string-to-sign,
        doesPolicySignatureV4Match)."""
        if self.fail_closed:
            raise AuthError("ServiceUnavailable",
                            "IAM configuration unavailable", 503)
        if not self.enabled:
            return None
        lower = {k.lower(): v for k, v in form.items()}
        policy = lower.get("policy", "")
        if not policy:
            raise AuthError("AccessDenied", "POST form without policy")
        if "x-amz-signature" in lower:
            cred = lower.get("x-amz-credential", "")
            access_key, _, scope = cred.partition("/")
            identity = self._lookup(access_key)
            date, region, service, _term = (scope.split("/") + [""] * 4)[:4]
            key = derive_signing_key(identity.secret_key, date,
                                     region, service or "s3")
            expect = hmac.new(key, policy.encode(),
                              hashlib.sha256).hexdigest()
            if not hmac.compare_digest(expect,
                                       lower["x-amz-signature"]):
                raise AuthError("SignatureDoesNotMatch",
                                "policy v4 signature mismatch")
            return identity
        if "awsaccesskeyid" in lower and "signature" in lower:
            identity = self._lookup(lower["awsaccesskeyid"])
            expect = signature_v2(identity.secret_key, policy)
            if not hmac.compare_digest(expect, lower["signature"]):
                raise AuthError("SignatureDoesNotMatch",
                                "policy v2 signature mismatch")
            return identity
        raise AuthError("AccessDenied", "POST form without signature")

    @staticmethod
    def _check_date(amz_date: str, scope: str) -> None:
        """Reject requests outside a 15-minute clock-skew window and
        requests whose x-amz-date disagrees with the credential-scope
        date (auth_signature_v4.go's replay protection)."""
        import calendar
        try:
            ts = calendar.timegm(time.strptime(amz_date,
                                               "%Y%m%dT%H%M%SZ"))
        except ValueError:
            raise AuthError("AuthorizationHeaderMalformed",
                            f"bad x-amz-date {amz_date!r}",
                            400) from None
        if abs(time.time() - ts) > 15 * 60:
            raise AuthError("RequestTimeTooSkewed",
                            "request time differs from server time by "
                            "more than 15 minutes")
        scope_date = scope.split("/", 1)[0]
        if scope_date != amz_date[:8]:
            raise AuthError("AuthorizationHeaderMalformed",
                            "credential scope date does not match "
                            "x-amz-date", 400)

    def authorize(self, identity: Identity | None, action: str,
                  bucket: str) -> None:
        if identity is None:  # anonymous mode: everything allowed
            return
        if not identity.allows(action, bucket):
            raise AuthError("AccessDenied",
                            f"{identity.name} may not {action} "
                            f"on {bucket}")
