"""The upload body of a POST or PUT: a raw body, or the first part of a
multipart/form-data form.

Port of `_parse_upload` of seaweedfs_tpu/server/volume_server.py, with
the port's `_first_part` fast path for the common multipart shape (the
same answers). Both stand apart from the volume server here, which
re-exports them, so that the filer server, which parses its uploads the
same way, imports neither the volume server nor the EC stack, and so no
torch.
"""

from __future__ import annotations

import re


def _parse_upload(headers, body: bytes) -> tuple[str, str, bytes]:
    """multipart/form-data or a raw body -> (name, mime, data). A
    multipart body in the common shape takes `_first_part`; any other
    goes through the email parser, as in the JAX package. Both give the
    same answer."""
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("multipart/form-data"):
        import email.parser
        import email.policy

        head = b"Content-Type: " + ctype.encode() + b"\r\n\r\n"
        outer = email.parser.BytesHeaderParser(policy=email.policy.HTTP).parsebytes(head)
        first = _first_part(outer.get_boundary(), body)
        if first is not None:
            return first
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(head + body)
        for part in msg.iter_parts():
            data = part.get_payload(decode=True)
            if data is None:
                continue
            return part.get_filename() or "", part.get_content_type(), data
        return "", "", b""
    return "", ctype if ctype != "application/octet-stream" else "", body


# one unfolded header line of a part: a field name, a colon, CRLF
_FIELD_LINE = re.compile(rb"[!-9;-~]+:[^\r\n]*\r\n")


def _first_part(boundary, body: bytes) -> tuple[str, str, bytes] | None:
    """(name, mime, data) of the first part of a multipart body in the
    shape clients send: no preamble, a delimiter line, CRLF header lines,
    a blank line, a payload in 7bit, 8bit or binary transfer encoding,
    then the next delimiter line. The email parser gives the same answer,
    at a cost that grows with the lines it splits a binary payload into
    and joins back (chip_smoke.py phase 14 times both on one needle).
    None where the body has another shape."""
    import email.parser
    import email.policy

    if not boundary:
        return None
    try:
        delim = b"--" + boundary.encode("ascii", "surrogateescape")
    except UnicodeEncodeError:
        return None
    # the rest of a delimiter line, as the email parser matches it: an
    # optional "--" (the close delimiter), blanks, the line's end
    rest = re.compile(rb"(--)?[ \t]*(\r\n|\r|\n|\Z)")
    m = rest.match(body, len(delim)) if body.startswith(delim) else None
    if m is None or m.group(1) or not m.group(2):
        return None  # a preamble, a close delimiter first, or no line end
    pos = start = m.end()
    while (field := _FIELD_LINE.match(body, pos)) is not None:
        pos = field.end()
    if pos == start or not body.startswith(b"\r\n", pos):
        return None
    part = email.parser.BytesHeaderParser(policy=email.policy.HTTP).parsebytes(body[start : pos + 2])
    cte = part.get("content-transfer-encoding")
    if part.get_content_maintype() in ("multipart", "message") or (
            cte is not None and str(cte).strip().lower() not in ("7bit", "8bit", "binary")):
        return None
    lo = at = pos + 2
    while True:
        at = body.find(delim, at)
        if at < 0:
            return None
        if rest.match(body, at + len(delim)):
            if at == lo:
                hi = lo  # an empty payload
                break
            if body[at - 1] in b"\r\n":
                # the line end before the delimiter line belongs to it
                hi = at - 2 if at - 2 >= lo and body[at - 2 : at] == b"\r\n" else at - 1
                break
        at += 1
    return part.get_filename() or "", part.get_content_type(), body[lo:hi]
