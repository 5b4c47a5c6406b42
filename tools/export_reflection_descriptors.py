"""Write the serialized FileDescriptorProtos the port's gRPC reflection serves.

The port (``igaming_platform_tpu_torch/serve/reflection.py``) answers server
reflection without protobuf, which the card's machine does not have: it
reads the descriptors of ``risk/v1/risk.proto``, its dependency
``google/protobuf/timestamp.proto``, ``grpc/health/v1/health.proto``,
``grpc/reflection/v1alpha/reflection.proto`` and ``wallet/v1/wallet.proto``
as data, from
``serve/reflection_descriptors.bin``. This tool writes that file from the
generated modules, where protobuf is installed:

    python -m tools.export_reflection_descriptors [OUT]

The format: the magic ``RDS1``, then per file a little-endian uint32 length
and the serialized FileDescriptorProto. ``tests/test_torch_reflection.py``
holds the committed file to this tool's output.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

OUT = (Path(__file__).resolve().parents[1] / "igaming_platform_tpu_torch" / "serve"
       / "reflection_descriptors.bin")
FILES = ("risk/v1/risk.proto", "google/protobuf/timestamp.proto",
         "grpc/health/v1/health.proto", "grpc/reflection/v1alpha/reflection.proto",
         "wallet/v1/wallet.proto")


def descriptor_blobs() -> list[bytes]:
    """The serialized FileDescriptorProto of each of ``FILES``, in order."""
    from google.protobuf import descriptor_pool

    from igaming_platform_tpu.proto_gen.grpc.reflection.v1alpha import reflection_pb2  # noqa: F401
    from igaming_platform_tpu.proto_gen.risk.v1 import risk_pb2  # noqa: F401
    from igaming_platform_tpu.proto_gen.wallet.v1 import wallet_pb2  # noqa: F401
    from igaming_platform_tpu.serve import grpc_server  # noqa: F401 — registers health.proto

    pool = descriptor_pool.Default()
    return [pool.FindFileByName(name).serialized_pb for name in FILES]


def encode(blobs: list[bytes]) -> bytes:
    return b"RDS1" + b"".join(struct.pack("<I", len(b)) + b for b in blobs)


def main(argv: list[str]) -> None:
    out = Path(argv[0]) if argv else OUT
    out.write_bytes(encode(descriptor_blobs()))
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
