"""S3 SelectObjectContent: request XML parsing + event-stream framing.

Reference: the reference serves S3-Select-ish queries via the volume
Query RPC (server/volume_grpc_query.go); the S3 surface here speaks the
real AWS wire shape — SelectObjectContentRequest XML in, and the
response as the AWS event-stream framing (prelude + CRCs) with
Records / Stats / End events, so aws-sdk/boto3 clients can consume it.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
import zlib


def _find_text(root, path: str, default: str = "") -> str:
    # Tolerate both namespaced and bare tags.
    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        if tag == path:
            return el.text or default
    return default


def parse_select_request(body: bytes) -> dict:
    """SelectObjectContentRequest -> {expression, input_format,
    csv_header, csv_delimiter, output_format}."""
    root = ET.fromstring(body)
    expression = _find_text(root, "Expression")
    out = {"expression": expression, "input_format": "json",
           "csv_header": True, "csv_delimiter": ",",
           "output_format": "json"}
    for el in root.iter():
        tag = el.tag.rsplit("}", 1)[-1]
        if tag == "InputSerialization":
            for sub in el.iter():
                st = sub.tag.rsplit("}", 1)[-1]
                if st == "CSV":
                    out["input_format"] = "csv"
                    out["csv_header"] = _find_text(
                        sub, "FileHeaderInfo", "USE").upper() != "NONE"
                    out["csv_delimiter"] = _find_text(
                        sub, "FieldDelimiter", ",") or ","
                elif st == "JSON":
                    out["input_format"] = "json"
        elif tag == "OutputSerialization":
            for sub in el.iter():
                st = sub.tag.rsplit("}", 1)[-1]
                if st == "CSV":
                    out["output_format"] = "csv"
    return out


# -- AWS event-stream framing ----------------------------------------------

def _header(name: str, value: str) -> bytes:
    nb = name.encode()
    vb = value.encode()
    return bytes([len(nb)]) + nb + b"\x07" + \
        struct.pack(">H", len(vb)) + vb


def _message(headers: list[tuple[str, str]], payload: bytes) -> bytes:
    hdr = b"".join(_header(n, v) for n, v in headers)
    total = 16 + len(hdr) + len(payload)
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))


def event_stream(records: bytes, bytes_scanned: int,
                 bytes_returned: int) -> bytes:
    """Records (chunked) + Stats + End events."""
    out = b""
    chunk = 1 << 20
    for i in range(0, len(records), chunk):
        out += _message(
            [(":message-type", "event"), (":event-type", "Records"),
             (":content-type", "application/octet-stream")],
            records[i:i + chunk])
    stats = (
        "<Stats><BytesScanned>%d</BytesScanned>"
        "<BytesProcessed>%d</BytesProcessed>"
        "<BytesReturned>%d</BytesReturned></Stats>"
        % (bytes_scanned, bytes_scanned, bytes_returned)).encode()
    out += _message(
        [(":message-type", "event"), (":event-type", "Stats"),
         (":content-type", "text/xml")], stats)
    out += _message(
        [(":message-type", "event"), (":event-type", "End")], b"")
    return out
