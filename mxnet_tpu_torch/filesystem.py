"""URI-aware file access (a copy of mxnet_tpu/filesystem.py; reference
role: dmlc-core's filesystem layer, src/io/{local_filesys,s3_filesys,
hdfs_filesys}.cc behind dmlc::Stream::Create).

Local paths and ``file://`` open directly; ``s3://`` opens through boto3
where it is importable (credentials from AWS_ACCESS_KEY_ID /
AWS_SECRET_ACCESS_KEY / S3_ENDPOINT, the reference's convention);
``hdfs://`` has no client and raises. The record readers and writers
(`recordio`, `io_record`) accept anything `open_uri` accepts.
"""
from __future__ import annotations

import io
import os

from .base import MXNetError

__all__ = ["open_uri", "scheme_of"]


def scheme_of(uri):
    """'s3' for s3://..., 'file' for file://..., '' for plain paths."""
    if "://" not in str(uri):
        return ""
    return str(uri).split("://", 1)[0].lower()


def _strip_file(uri):
    s = str(uri)
    return s[len("file://"):] if s.startswith("file://") else s


def _s3_parts(uri):
    rest = str(uri)[len("s3://"):]
    bucket, _, key = rest.partition("/")
    if not bucket or not key:
        raise MXNetError("malformed S3 uri %r (want s3://bucket/key)" % uri)
    return bucket, key


def _s3_client():
    try:
        import boto3
    except ImportError:
        raise MXNetError(
            "s3:// paths need boto3, which is not installed in this "
            "environment; stage the file locally (or install boto3 — "
            "credentials follow the usual AWS_ACCESS_KEY_ID/"
            "AWS_SECRET_ACCESS_KEY/S3_ENDPOINT variables, the "
            "reference's s3_filesys.cc convention)")
    endpoint = os.environ.get("S3_ENDPOINT")
    return boto3.client("s3", endpoint_url=endpoint)


def open_uri(uri, mode="rb"):
    """Open a local path, file://, or s3:// uri. Returns a file-like
    object; s3 reads are fully buffered (RecordIO wants seekable), s3
    writes upload on close."""
    scheme = scheme_of(uri)
    if scheme in ("", "file"):
        return open(_strip_file(uri), mode)
    if scheme == "s3":
        client = _s3_client()
        bucket, key = _s3_parts(uri)
        if "r" in mode:
            body = client.get_object(Bucket=bucket, Key=key)["Body"].read()
            return io.BytesIO(body)
        if "w" in mode:
            return _S3WriteBuffer(client, bucket, key)
        raise MXNetError("s3 open mode %r not supported" % mode)
    if scheme == "hdfs":
        raise MXNetError(
            "hdfs:// is not available in this environment (no libhdfs); "
            "stage the file locally — the reference has the same "
            "build-time requirement (dmlc USE_HDFS=1)")
    raise MXNetError("unsupported uri scheme %r in %r" % (scheme, uri))


class _S3WriteBuffer(io.BytesIO):
    def __init__(self, client, bucket, key):
        super().__init__()
        self._dest = (client, bucket, key)
        self._closed_once = False

    def close(self):
        if not self._closed_once:
            self._closed_once = True
            client, bucket, key = self._dest
            client.put_object(Bucket=bucket, Key=key,
                              Body=self.getvalue())
        super().close()
