"""aws-chunked (streaming SigV4) body decoding with signature checks.

Port of seaweedfs_tpu/s3/chunked.py, whole: the same frames, byte for
byte, and the same refusals.

Reference: weed/s3api/chunked_reader_v4.go — most real AWS SDKs send
PUT bodies as STREAMING-AWS4-HMAC-SHA256-PAYLOAD: the Authorization
header signs a seed, then every chunk frame
``hex(size);chunk-signature=<sig>\r\n<data>\r\n`` carries a signature
chained from the previous one. The unsigned-trailer variants
(STREAMING-UNSIGNED-PAYLOAD-TRAILER) frame chunks without signatures
and append trailing checksum headers after the final 0-chunk.
"""

from __future__ import annotations

from .auth import (
    S3AuthError,
    SigningContext,
    verify_chunk_signature,
    verify_trailer_signature,
)


def decode_aws_chunked(
    body: bytes,
    ctx: SigningContext | None = None,
    signed: bool = False,
) -> bytes:
    """Strip aws-chunked framing; verify the chunk-signature chain when
    `signed` (requires ctx from header auth).

    Raises S3AuthError on any broken or missing chunk signature —
    a truncated or tampered stream must not be stored.
    """
    out = []
    pos = 0
    prev_sig = ctx.seed_signature if ctx is not None else ""
    saw_final = False
    while pos < len(body):
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            break
        header = body[pos:nl]
        if b":" in header.split(b";")[0]:
            # trailer header block after the final chunk
            break
        parts = header.split(b";")
        try:
            size = int(parts[0], 16)
        except ValueError as e:
            raise S3AuthError("InvalidRequest", f"bad chunk header {header!r}") from e
        chunk = body[nl + 2 : nl + 2 + size]
        if len(chunk) != size:
            raise S3AuthError("IncompleteBody", "truncated chunk")
        if signed:
            sig = ""
            for p in parts[1:]:
                if p.startswith(b"chunk-signature="):
                    sig = p[len(b"chunk-signature=") :].decode()
            if ctx is None or not sig:
                raise S3AuthError("AccessDenied", "missing chunk signature")
            want = verify_chunk_signature(ctx, prev_sig, chunk)
            if not _ct_eq(want, sig):
                raise S3AuthError(
                    "SignatureDoesNotMatch", "chunk signature mismatch"
                )
            prev_sig = sig
        if size == 0:
            saw_final = True
            pos = nl + 2
            break
        out.append(chunk)
        pos = nl + 2 + size + 2
    if signed and not saw_final:
        raise S3AuthError("IncompleteBody", "missing final chunk")
    # trailer block (x-amz-checksum-*, x-amz-trailer-signature)
    if signed and pos < len(body):
        trailer = body[pos:]
        lines = [ln for ln in trailer.split(b"\r\n") if ln]
        canonical = []
        trailer_sig = ""
        for ln in lines:
            k, _, v = ln.partition(b":")
            if k.strip().lower() == b"x-amz-trailer-signature":
                trailer_sig = v.strip().decode()
            else:
                canonical.append(k.strip().lower() + b":" + v.strip() + b"\n")
        if trailer_sig:
            want = verify_trailer_signature(ctx, prev_sig, b"".join(canonical))
            if not _ct_eq(want, trailer_sig):
                raise S3AuthError(
                    "SignatureDoesNotMatch", "trailer signature mismatch"
                )
    return b"".join(out)


def _ct_eq(a: str, b: str) -> bool:
    import hmac as _hmac

    return _hmac.compare_digest(a, b)


def encode_aws_chunked(
    data: bytes, ctx: SigningContext, chunk_size: int = 64 * 1024
) -> bytes:
    """Produce a signed aws-chunked body (test helper mirroring what an
    AWS SDK client sends)."""
    out = []
    prev = ctx.seed_signature
    chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]
    chunks.append(b"")
    for c in chunks:
        sig = verify_chunk_signature(ctx, prev, c)
        out.append(f"{len(c):x};chunk-signature={sig}\r\n".encode())
        out.append(c)
        out.append(b"\r\n")
        prev = sig
    return b"".join(out)
