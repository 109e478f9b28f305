"""POST-policy parsing and enforcement (browser-form uploads).

Reference: weed/s3api/policy/post-policy.go + postpolicyform.go — the
base64 JSON policy a client signs lists an expiration plus conditions
(["eq", "$key", v], ["starts-with", "$key", p], {"key": v},
["content-length-range", lo, hi]); every form field must satisfy its
condition and, conversely, fields not covered by the policy are
rejected (checkPostPolicy) so a signature can't be replayed with
extra fields.
"""

from __future__ import annotations

import base64
import calendar
import json
import time

from .auth import AuthError

# Form fields that never need a policy condition
# (postpolicyform.go ignores these in the coverage check).
_EXEMPT = {
    "policy", "signature", "awsaccesskeyid", "file",
    "x-amz-signature", "x-amz-credential", "x-amz-algorithm",
    "x-amz-date", "success_action_status",
}


class PostPolicy:
    def __init__(self, expiration: float,
                 conditions: list, raw: dict):
        self.expiration = expiration
        self.conditions = conditions
        self.raw = raw

    @classmethod
    def parse(cls, policy_b64: str) -> "PostPolicy":
        try:
            doc = json.loads(base64.b64decode(policy_b64))
        except Exception as e:  # noqa: BLE001
            raise AuthError("MalformedPOSTRequest",
                            f"unparseable policy: {e}", 400) from None
        exp_raw = doc.get("expiration", "")
        exp = None
        for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
            try:
                exp = calendar.timegm(time.strptime(exp_raw, fmt))
                break
            except ValueError:
                continue
        if exp is None:
            raise AuthError("MalformedPOSTRequest",
                            f"bad policy expiration {exp_raw!r}", 400)
        return cls(exp, doc.get("conditions", []), doc)

    def check(self, form: dict[str, str], content_length: int) -> None:
        """Enforce expiration, every condition, and full coverage of
        the submitted fields (checkPostPolicy)."""
        if time.time() > self.expiration:
            raise AuthError("AccessDenied", "policy has expired")
        covered: set[str] = set()
        lower = {k.lower(): v for k, v in form.items()}
        for cond in self.conditions:
            if isinstance(cond, dict):
                items = [["eq", f"${k}", v] for k, v in cond.items()]
            elif isinstance(cond, list) and len(cond) == 3:
                items = [cond]
            else:
                raise AuthError("MalformedPOSTRequest",
                                f"bad condition {cond!r}", 400)
            for op, target, value in items:
                op = str(op).lower()
                if op not in ("eq", "starts-with",
                              "content-length-range"):
                    # An unrecognized operator must REJECT the policy,
                    # not silently leave the field unconstrained.
                    raise AuthError("MalformedPOSTRequest",
                                    f"unsupported condition {op!r}", 400)
                if op == "content-length-range":
                    try:
                        lo, hi = int(target), int(value)
                    except (TypeError, ValueError):
                        raise AuthError(
                            "MalformedPOSTRequest",
                            "non-numeric content-length-range",
                            400) from None
                    if not lo <= content_length <= hi:
                        raise AuthError(
                            "EntityTooLarge" if content_length > hi
                            else "EntityTooSmall",
                            f"content length {content_length} outside "
                            f"[{lo}, {hi}]", 400)
                    continue
                name = str(target).lstrip("$").lower()
                covered.add(name)
                got = lower.get(name, "")
                if op == "eq" and got != value:
                    raise AuthError(
                        "AccessDenied",
                        f"policy condition failed: {name} == {value!r}")
                if op == "starts-with" and \
                        not got.startswith(str(value)):
                    raise AuthError(
                        "AccessDenied",
                        f"policy condition failed: {name} "
                        f"starts-with {value!r}")
        for name in lower:
            if name in _EXEMPT or name.startswith("x-ignore-"):
                continue
            if name not in covered:
                raise AuthError(
                    "AccessDenied",
                    f"form field {name!r} not covered by the policy")


def parse_multipart_form(body: bytes, content_type: str
                         ) -> tuple[dict[str, str], str, bytes, str]:
    """multipart/form-data -> (fields, file_name, file_bytes,
    file_content_type).

    Minimal RFC 7578 parser for the browser-POST upload surface; the
    `file` part must come last (AWS requires it: fields after the file
    are ignored — here rejected implicitly by coverage checks).  The
    file part's own Content-Type is returned separately — it is part
    of the upload, NOT a form field needing policy coverage.
    """
    marker = "boundary="
    i = content_type.find(marker)
    if i < 0:
        raise AuthError("MalformedPOSTRequest",
                        "multipart body without boundary", 400)
    boundary = content_type[i + len(marker):].split(";")[0].strip()
    if boundary.startswith('"') and boundary.endswith('"'):
        boundary = boundary[1:-1]
    delim = b"--" + boundary.encode()
    fields: dict[str, str] = {}
    file_name, file_bytes, file_ctype = "", b"", ""
    # Split on CRLF+delimiter so part content keeps its own trailing
    # newlines byte-exact (RFC 2046: the CRLF before a boundary belongs
    # to the boundary, not the content).  Normalize the first
    # delimiter, which has no preceding CRLF.
    if body.startswith(delim):
        body = b"\r\n" + body
    segments = body.split(b"\r\n" + delim)
    for part in segments[1:]:  # [0] is the preamble
        if part.startswith(b"--"):
            break  # closing delimiter
        if part.startswith(b"\r\n"):
            part = part[2:]
        head, _, content = part.partition(b"\r\n\r\n")
        disp = ""
        ptype = ""
        for line in head.split(b"\r\n"):
            text = line.decode("utf-8", "replace")
            if text.lower().startswith("content-disposition:"):
                disp = text
            elif text.lower().startswith("content-type:"):
                ptype = text.split(":", 1)[1].strip()
        name = _disp_param(disp, "name")
        if name is None:
            continue
        filename = _disp_param(disp, "filename")
        if name == "file" or filename is not None:
            file_name = filename or ""
            file_bytes = content
            file_ctype = ptype
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, file_name, file_bytes, file_ctype


def _disp_param(disposition: str, param: str) -> str | None:
    for piece in disposition.split(";"):
        piece = piece.strip()
        if piece.startswith(param + "="):
            val = piece[len(param) + 1:]
            return val[1:-1] if val.startswith('"') else val
    return None
