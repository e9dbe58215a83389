"""S3-compatible object-store model repository.

The reference's remote model stores keep model blobs out of the metadata
database so a model trained on one host deploys from another
(storage/s3/.../S3Models.scala:36, storage/hdfs/.../HDFSModels.scala:31).
This backend talks to any S3-compatible endpoint (AWS, GCS interop, minio)
through boto3, which is an optional dependency (``pip install
predictionio-tpu[s3]``) — construction fails with a clear error when it is
missing, and tests inject a fake client.

Config (see conf/pio-env.sh.template)::

    PIO_STORAGE_SOURCES_<NAME>_TYPE=s3
    PIO_STORAGE_SOURCES_<NAME>_BUCKET=my-models
    PIO_STORAGE_SOURCES_<NAME>_PREFIX=pio/        # optional
    PIO_STORAGE_SOURCES_<NAME>_ENDPOINT=...       # optional (minio etc.)
    PIO_STORAGE_SOURCES_<NAME>_REGION=...         # optional

Multipart checkpoints map naturally here: each part is its own object
(``<prefix>pio_model_<id>:part:<leafN>``), so shards upload/download
independently and a deploy host can fetch table shards in parallel.
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.data.storage import base


def _make_boto3_client(region: str | None, endpoint: str | None):
    try:
        import boto3  # type: ignore
    except ImportError as e:  # pragma: no cover - exercised via injection
        raise ImportError(
            "the s3 model store requires boto3; install with "
            "`pip install predictionio-tpu[s3]`"
        ) from e
    return boto3.client("s3", region_name=region, endpoint_url=endpoint)


class S3Models(base.Models):
    def __init__(
        self,
        bucket: str,
        prefix: str = "",
        region: str | None = None,
        endpoint: str | None = None,
        client: Any | None = None,
    ):
        if not bucket:
            raise ValueError("s3 model store requires a BUCKET")
        self.bucket = bucket
        self.prefix = prefix
        self.client = client or _make_boto3_client(region, endpoint)
        # boto3-compatible clients expose the modeled missing-key error here
        self._missing = self.client.exceptions.NoSuchKey

    def _key(self, instance_id: str) -> str:
        return f"{self.prefix}pio_model_{instance_id}"

    def insert(self, instance_id: str, blob: bytes) -> None:
        self.client.put_object(
            Bucket=self.bucket, Key=self._key(instance_id), Body=blob
        )

    def get(self, instance_id: str) -> bytes | None:
        try:
            r = self.client.get_object(
                Bucket=self.bucket, Key=self._key(instance_id)
            )
        except self._missing:
            return None
        body = r["Body"]
        return body.read() if hasattr(body, "read") else body

    def _exists(self, key: str) -> bool:
        head = getattr(self.client, "head_object", None)
        if head is None:  # minimal injected clients: fall back to get
            try:
                # ranged get: answer existence without downloading the blob
                self.client.get_object(
                    Bucket=self.bucket, Key=key, Range="bytes=0-0"
                )
                return True
            except self._missing:
                return False
            except TypeError:
                # client doesn't accept Range at all: plain get (the
                # pre-Range behavior, still correct, just heavier)
                try:
                    self.client.get_object(Bucket=self.bucket, Key=key)
                    return True
                except self._missing:
                    return False
            except Exception as e:
                # zero-byte objects answer a ranged GET with 416
                # InvalidRange — the key exists
                status = (
                    getattr(e, "response", None) or {}
                ).get("ResponseMetadata", {}).get("HTTPStatusCode")
                if status == 416:
                    return True
                raise
        try:
            head(Bucket=self.bucket, Key=key)
            return True
        except Exception as e:
            # boto3 head_object raises ClientError(404), not NoSuchKey
            if isinstance(e, self._missing):
                return False
            status = (
                getattr(e, "response", None) or {}
            ).get("ResponseMetadata", {}).get("HTTPStatusCode")
            if status == 404:
                return False
            raise

    def delete(self, instance_id: str) -> bool:
        key = self._key(instance_id)
        if not self._exists(key):
            return False
        self.client.delete_object(Bucket=self.bucket, Key=key)
        return True
