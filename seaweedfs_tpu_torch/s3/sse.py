"""Server-side encryption: SSE-C (customer keys) and SSE-S3 (managed
keyring), with a KMS SPI for external key services.

Port of seaweedfs_tpu/s3/sse.py, whole: the same ciphertexts, wrapped
keys and extended attributes, so each package reads what the other
wrote. `cryptography` stays optional, as in the JAX module.

Reference surface: weed/s3api/s3_sse_c.go (customer-key validation,
MD5 binding), weed/s3api/s3_sse_kms.go + weed/kms/ (provider SPI,
envelope encryption). The cipher here is AES-256-CTR: it is
length-preserving (ciphertext length == plaintext length, so
Content-Length/Range arithmetic is unchanged) and seekable (a range
read decrypts from any 16-byte block boundary without touching
preceding bytes).

Envelope scheme for SSE-S3: every object gets a fresh random 256-bit
data key; the data key is wrapped by the keyring's master key
(AES-256-GCM, nonce||ct||tag) and stored in the entry's extended
attributes. Rotating the master key never requires re-encrypting data,
only re-wrapping keys.
"""

from __future__ import annotations

import base64
import hashlib
import os

# `cryptography` is an optional dependency: the S3 gateway itself must
# import without it — only the SSE features need the cipher, and they
# raise NotImplemented when it is absent instead of poisoning the whole
# gateway import.
try:
    from cryptography.hazmat.primitives.ciphers import (
        Cipher,
        algorithms,
        modes,
    )
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # pragma: no cover - exercised in slim containers
    Cipher = algorithms = modes = AESGCM = None

# entry.extended attribute keys
SSE_ALGO_KEY = "s3-sse"  # b"SSE-C" | b"AES256"
SSE_IV_KEY = "s3-sse-iv"
SSE_KEY_MD5_KEY = "s3-sse-c-key-md5"  # base64 MD5 of the customer key
SSE_WRAPPED_KEY = "s3-sse-wrapped-key"  # keyring-wrapped data key
SSE_KEY_ID_KEY = "s3-sse-key-id"
# multipart objects: JSON [[plaintext_len, iv_hex], ...] in part order.
# Each part is an INDEPENDENT CTR stream under the object's data key
# with its own random IV (a re-uploaded part gets a fresh IV, so no
# counter stream is ever reused with different plaintext).
SSE_PART_MAP_KEY = "s3-sse-parts"

CUSTOMER_PREFIX = "x-amz-server-side-encryption-customer-"
COPY_CUSTOMER_PREFIX = "x-amz-copy-source-server-side-encryption-customer-"


class SseError(Exception):
    """Carries the S3 error code the gateway should map to."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


def _require_crypto() -> None:
    if Cipher is None:
        raise SseError(
            "NotImplemented",
            "SSE requires the 'cryptography' package (not installed)",
        )


def _ctr_apply(key: bytes, iv: bytes, data: bytes, block_offset: int = 0) -> bytes:
    """AES-256-CTR transform (encrypt == decrypt). block_offset seeks
    the counter forward for range reads (units of 16-byte blocks)."""
    _require_crypto()
    if block_offset:
        ctr = (int.from_bytes(iv, "big") + block_offset) % (1 << 128)
        iv = ctr.to_bytes(16, "big")
    enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
    return enc.update(data) + enc.finalize()


def encrypt(key: bytes, data: bytes) -> tuple[bytes, bytes]:
    """-> (iv, ciphertext)."""
    iv = os.urandom(16)
    return iv, _ctr_apply(key, iv, data)


def decrypt(key: bytes, iv: bytes, data: bytes) -> bytes:
    return _ctr_apply(key, iv, data)


def decrypt_range(key: bytes, iv: bytes, ct_from_aligned: bytes, offset: int) -> bytes:
    """Decrypt a ciphertext slice read starting at the 16-byte-aligned
    offset `offset - offset % 16`; returns the plaintext for the
    requested offset (prefix within the first block dropped)."""
    skip = offset % 16
    pt = _ctr_apply(key, iv, ct_from_aligned, block_offset=offset // 16)
    return pt[skip:]


def key_md5_b64(key: bytes) -> str:
    return base64.b64encode(hashlib.md5(key).digest()).decode()


def parse_customer_headers(headers, prefix: str = CUSTOMER_PREFIX) -> bytes | None:
    """Validate the SSE-C header triple; returns the 256-bit key or
    None when no SSE-C headers are present. Key-MD5 binding is
    mandatory (reference s3_sse_c.go: a transposed key must fail
    closed, not decrypt garbage)."""
    algo = headers.get(prefix + "algorithm")
    key_b64 = headers.get(prefix + "key")
    md5_b64 = headers.get(prefix + "key-MD5") or headers.get(prefix + "key-md5")
    if not algo and not key_b64:
        return None
    if algo != "AES256":
        raise SseError(
            "InvalidArgument", f"unsupported SSE-C algorithm {algo!r}"
        )
    if not key_b64 or not md5_b64:
        raise SseError("InvalidArgument", "SSE-C requires key and key-MD5")
    try:
        key = base64.b64decode(key_b64, validate=True)
    except Exception:
        raise SseError("InvalidArgument", "SSE-C key is not valid base64") from None
    if len(key) != 32:
        raise SseError("InvalidArgument", "SSE-C key must be 256 bits")
    if key_md5_b64(key) != md5_b64:
        raise SseError("InvalidArgument", "SSE-C key MD5 mismatch")
    return key


# ---------------------------------------------------------------------------
# KMS SPI + local keyring
# ---------------------------------------------------------------------------


class KmsProvider:
    """SPI for data-key generation/unwrap (reference weed/kms/). An
    external KMS plugs in by implementing these two methods."""

    key_id: str

    def generate_data_key(self) -> tuple[str, bytes, bytes]:
        """-> (key_id, plaintext_data_key, wrapped_data_key)."""
        raise NotImplementedError

    def decrypt_data_key(self, key_id: str, wrapped: bytes) -> bytes:
        raise NotImplementedError


class LocalKeyring(KmsProvider):
    """SSE-S3 default: a single local master key wrapping per-object
    data keys with AES-256-GCM."""

    def __init__(self, master_key: bytes, key_id: str = "local-0"):
        if len(master_key) != 32:
            raise ValueError("master key must be 256 bits")
        # without `cryptography` the keyring still constructs (the
        # gateway boots); only actually wrapping/unwrapping keys raises
        self._master = AESGCM(master_key) if AESGCM is not None else None
        self.key_id = key_id

    def generate_data_key(self) -> tuple[str, bytes, bytes]:
        if self._master is None:
            _require_crypto()
        dk = os.urandom(32)
        nonce = os.urandom(12)
        wrapped = nonce + self._master.encrypt(nonce, dk, self.key_id.encode())
        return self.key_id, dk, wrapped

    def decrypt_data_key(self, key_id: str, wrapped: bytes) -> bytes:
        if self._master is None:
            _require_crypto()
        if key_id != self.key_id:
            raise SseError("InvalidArgument", f"unknown SSE-S3 key id {key_id!r}")
        try:
            return self._master.decrypt(
                wrapped[:12], wrapped[12:], key_id.encode()
            )
        except Exception:
            raise SseError(
                "InternalError", "SSE-S3 data key unwrap failed"
            ) from None


def load_or_create_keyring(kv_get, kv_put, kv_put_if_absent=None) -> LocalKeyring:
    """Master key persisted in the filer KV store so every gateway
    instance over the same filer shares it. First-boot creation uses
    the store's atomic create-if-absent when available (both embedded
    stores provide it), so two racing gateways deterministically adopt
    the ONE stored key — a lost race with plain put/re-read would leave
    a process holding a divergent in-memory key whose wrapped objects
    become undecryptable after restart."""
    k = b"s3-sse/master-key"
    raw = kv_get(k)
    if raw is not None and len(raw) == 32:
        return LocalKeyring(raw)
    if raw is None and kv_put_if_absent is not None:
        raw = kv_put_if_absent(k, os.urandom(32))
    else:  # no atomic primitive — or a CORRUPT stored value, which
        #    put-if-absent could never repair (it returns the existing
        #    bytes): overwrite, then adopt whatever the store holds
        kv_put(k, os.urandom(32))
        raw = kv_get(k)
    if raw is None or len(raw) != 32:  # pragma: no cover - kv broken
        raise SseError("InternalError", "could not persist SSE master key")
    return LocalKeyring(raw)


# ---------------------------------------------------------------------------
# entry helpers (shared by PUT/GET/HEAD/copy paths)
# ---------------------------------------------------------------------------


def encrypt_for_put(
    data: bytes,
    ssec_key: bytes | None,
    sse_algo: str,
    keyring: KmsProvider | None,
) -> tuple[bytes, dict, dict]:
    """-> (stored_bytes, extended_attrs, response_headers)."""
    if ssec_key is not None and sse_algo:
        raise SseError(
            "InvalidArgument", "SSE-C and x-amz-server-side-encryption conflict"
        )
    if ssec_key is not None:
        iv, ct = encrypt(ssec_key, data)
        ext = {
            SSE_ALGO_KEY: b"SSE-C",
            SSE_IV_KEY: iv,
            SSE_KEY_MD5_KEY: key_md5_b64(ssec_key).encode(),
        }
        hdrs = {
            CUSTOMER_PREFIX + "algorithm": "AES256",
            CUSTOMER_PREFIX + "key-MD5": key_md5_b64(ssec_key),
        }
        return ct, ext, hdrs
    if sse_algo:
        if sse_algo == "aws:kms":
            # Honest 501 over silently downgrading to the local keyring
            # and reporting AES256 (compliance tooling would believe
            # KMS-wrapped keys are in use).
            raise SseError(
                "NotImplemented", "aws:kms requires an external KMS provider"
            )
        if sse_algo != "AES256":
            raise SseError(
                "InvalidArgument",
                f"unsupported x-amz-server-side-encryption {sse_algo!r}",
            )
        if keyring is None:
            raise SseError("InvalidRequest", "SSE-S3 keyring not configured")
        key_id, dk, wrapped = keyring.generate_data_key()
        iv, ct = encrypt(dk, data)
        ext = {
            SSE_ALGO_KEY: b"AES256",
            SSE_IV_KEY: iv,
            SSE_WRAPPED_KEY: wrapped,
            SSE_KEY_ID_KEY: key_id.encode(),
        }
        return ct, ext, {"x-amz-server-side-encryption": "AES256"}
    return data, {}, {}


def resolve_put_encryption(headers, bucket_default: str = ""):
    """One header triage for EVERY write path (single PUT, copy dest,
    multipart initiate): -> (ssec_key | None, algo str). Raises
    SseError for SSE-C/algo conflicts and for aws:kms (honest 501 —
    silently downgrading to the local keyring would misreport
    compliance)."""
    ssec_key = parse_customer_headers(headers)
    algo = headers.get("x-amz-server-side-encryption", "")
    if ssec_key is not None and algo:
        raise SseError(
            "InvalidArgument", "SSE-C and x-amz-server-side-encryption conflict"
        )
    if ssec_key is None and not algo:
        algo = bucket_default
    if algo == "aws:kms":
        raise SseError(
            "NotImplemented", "aws:kms requires an external KMS provider"
        )
    if algo and algo != "AES256":
        raise SseError(
            "InvalidArgument",
            f"unsupported x-amz-server-side-encryption {algo!r}",
        )
    return ssec_key, algo


def entry_sse_algo(entry) -> str:
    return (entry.extended.get(SSE_ALGO_KEY) or b"").decode()


def decrypt_key_for_entry(
    entry, ssec_key: bytes | None, keyring: KmsProvider | None
) -> bytes | None:
    """Resolve the data key needed to read `entry` (None = plaintext
    object). Raises SseError when required key material is absent or
    wrong — fail closed, never serve ciphertext as content."""
    algo = entry_sse_algo(entry)
    if not algo:
        if ssec_key is not None:
            raise SseError(
                "InvalidRequest", "object is not SSE-C encrypted"
            )
        return None
    if algo == "SSE-C":
        if ssec_key is None:
            raise SseError(
                "InvalidRequest",
                "object was stored with SSE-C; key headers required",
            )
        want = (entry.extended.get(SSE_KEY_MD5_KEY) or b"").decode()
        if key_md5_b64(ssec_key) != want:
            raise SseError("AccessDenied", "SSE-C key does not match object key")
        return ssec_key
    if algo == "AES256":
        if keyring is None:
            raise SseError("InternalError", "SSE-S3 keyring not configured")
        key_id = (entry.extended.get(SSE_KEY_ID_KEY) or b"").decode()
        wrapped = entry.extended.get(SSE_WRAPPED_KEY) or b""
        return keyring.decrypt_data_key(key_id, wrapped)
    raise SseError("InternalError", f"unknown SSE algorithm {algo!r}")


def read_decrypted(read_fn, entry, key: bytes, offset: int, size: int) -> bytes:
    """Decrypt entry bytes [offset, offset+size) (size < 0 = to end).
    read_fn(off, sz) returns ciphertext from the store. Handles both
    single-IV objects and multipart part-maps (each part its own CTR
    stream; range reads seek within the owning part's counter)."""
    import json as _json

    pm_raw = entry.extended.get(SSE_PART_MAP_KEY)
    if not pm_raw:
        iv = entry.extended.get(SSE_IV_KEY) or b""
        aligned = offset - offset % 16
        want = size if size < 0 else size + (offset - aligned)
        ct = read_fn(aligned, want)
        pt = decrypt_range(key, iv, ct, offset)
        return pt if size < 0 else pt[:size]
    parts = _json.loads(pm_raw)
    total = sum(int(length) for length, _iv in parts)
    end = total if size < 0 else min(offset + size, total)
    out = bytearray()
    part_start = 0
    for length, iv_hex in parts:
        length = int(length)
        lo = max(offset, part_start)
        hi = min(end, part_start + length)
        if lo < hi:
            in_off = lo - part_start
            aligned_in = in_off - in_off % 16
            ct = read_fn(
                part_start + aligned_in, (hi - part_start) - aligned_in
            )
            pt = decrypt_range(key, bytes.fromhex(iv_hex), ct, in_off)
            out += pt[: hi - lo]
        part_start += length
        if part_start >= end:
            break
    return bytes(out)


def response_headers_for_entry(entry) -> dict:
    algo = entry_sse_algo(entry)
    if algo == "SSE-C":
        return {
            CUSTOMER_PREFIX + "algorithm": "AES256",
            CUSTOMER_PREFIX
            + "key-MD5": (entry.extended.get(SSE_KEY_MD5_KEY) or b"").decode(),
        }
    if algo == "AES256":
        return {"x-amz-server-side-encryption": "AES256"}
    return {}
