"""gRPC server reflection (v1alpha) without protobuf or grpcio.

The port's counterpart of ``igaming_platform_tpu/serve/reflection.py``: the
risk server registers reflection so grpcurl can drive it without local
proto files. The card's machine has neither protobuf nor grpcio, so this
module answers from data: ``reflection_descriptors.bin`` holds the
serialized FileDescriptorProtos of ``risk/v1/risk.proto``, its dependency
``google/protobuf/timestamp.proto``, ``grpc/health/v1/health.proto``,
``grpc/reflection/v1alpha/reflection.proto`` and ``wallet/v1/wallet.proto``
(written by the repository's
``tools/export_reflection_descriptors.py`` from the generated modules).

``ReflectionService.respond(request_bytes)`` answers one
ServerReflectionRequest with ServerReflectionResponse bytes, as the JAX
servicer does: list_services, file_by_filename, file_containing_symbol
(services, methods, messages, nested types, fields, oneofs, enums and enum
values; a bogus leaf under a real parent is NOT_FOUND, not its parent's
file), file_containing_extension and all_extension_numbers_of_type (none of
these files declares an extension), an empty request UNIMPLEMENTED. A file
comes with its transitive dependencies. Messages are read and written with
``serve/risk_codec.py``'s proto3 varint and length-delimited primitives.
``register(server, names)`` binds it to a ``serve/grpc_wire.Server`` as the
bidirectional ServerReflectionInfo stream: several requests on one stream,
one response each, answered as each arrives, as grpcurl and grpcio's
reflection client send them (``serve/grpc_server.serve_risk``,
``serve_wallet``, ``serve/router.serve_router``).
"""

from __future__ import annotations

import struct
from pathlib import Path

from igaming_platform_tpu_torch.serve.risk_codec import _delimited, _read_varint, _skip, _varint

SERVICE_NAME = "grpc.reflection.v1alpha.ServerReflection"
DESCRIPTORS = Path(__file__).resolve().parent / "reflection_descriptors.bin"

_NOT_FOUND = 5      # grpc.StatusCode.NOT_FOUND
_UNIMPLEMENTED = 12

# ServerReflectionRequest's message_request oneof: field number -> name.
_REQUEST_KINDS = {3: "file_by_filename", 4: "file_containing_symbol",
                  5: "file_containing_extension", 6: "all_extension_numbers_of_type",
                  7: "list_services"}


def _fields(buf: bytes):
    """(number, wire type, value) of each field of one message: a varint as
    an int, a length-delimited field as its bytes."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos, end)
        elif wire == 2:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise ValueError("truncated length-delimited field")
            value = bytes(buf[pos:pos + n])
            pos += n
        else:
            start = pos
            pos = _skip(buf, pos, end, wire)
            value = bytes(buf[start:pos])
        yield number, wire, value


def _name(buf: bytes) -> str:
    """Field 1 (``name``) of a descriptor message."""
    for number, wire, value in _fields(buf):
        if number == 1 and wire == 2:
            return value.decode()
    return ""


class _File:
    """One FileDescriptorProto: its name, dependencies and symbols.

    ``symbols`` holds what the JAX servicer's descriptor pool finds by full
    name (a package is not one): messages (nested too), enums, enum values
    in their enum's enclosing scope, fields, oneofs, services, methods and
    extensions; ``members`` maps a service, message or enum to the leaf
    names the JAX servicer accepts under it."""

    def __init__(self, blob: bytes):
        self.blob = blob
        self.name, self.package, self.deps = "", "", []
        self.symbols: set[str] = set()
        self.members: dict[str, set[str]] = {}
        self.messages: set[str] = set()
        body = []
        for number, _, value in _fields(blob):
            if number == 1:
                self.name = value.decode()
            elif number == 2:
                self.package = value.decode()
            elif number == 3:
                self.deps.append(value.decode())
            elif number in (4, 5, 6, 7):
                body.append((number, value))
        scope = self.package
        for number, value in body:
            if number == 4:
                self._message(scope, value)
            elif number == 5:
                self._enum(scope, value)
            elif number == 6:
                self._service(scope, value)
            else:
                self.symbols.add(_join(scope, _name(value)))

    def _message(self, scope: str, buf: bytes) -> None:
        full = _join(scope, _name(buf))
        self.symbols.add(full)
        self.messages.add(full)
        members = self.members.setdefault(full, set())
        for number, _, value in _fields(buf):
            if number in (2, 6, 8):  # field, extension, oneof
                leaf = _name(value)
                members.add(leaf)
                self.symbols.add(_join(full, leaf))
            elif number == 3:  # nested type
                members.add(_name(value))
                self._message(full, value)
            elif number == 4:  # nested enum
                members.add(_name(value))
                self._enum(full, value)

    def _enum(self, scope: str, buf: bytes) -> None:
        full = _join(scope, _name(buf))
        self.symbols.add(full)
        values = self.members.setdefault(full, set())
        for number, _, value in _fields(buf):
            if number == 2:
                values.add(_name(value))
                self.symbols.add(_join(scope, _name(value)))  # C++ scoping: siblings

    def _service(self, scope: str, buf: bytes) -> None:
        full = _join(scope, _name(buf))
        self.symbols.add(full)
        methods = self.members.setdefault(full, set())
        for number, _, value in _fields(buf):
            if number == 2:
                methods.add(_name(value))
                self.symbols.add(_join(full, _name(value)))


def _join(scope: str, name: str) -> str:
    return f"{scope}.{name}" if scope else name


def load_descriptors(path: Path = DESCRIPTORS) -> list[bytes]:
    """The serialized FileDescriptorProtos of ``reflection_descriptors.bin``."""
    data = path.read_bytes()
    if data[:4] != b"RDS1":
        raise ValueError(f"{path}: not a reflection descriptor set")
    out, pos = [], 4
    while pos < len(data):
        (n,) = struct.unpack_from("<I", data, pos)
        out.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


class ReflectionService:
    """ServerReflectionInfo over the descriptor set: one response per
    request, any order."""

    def __init__(self, service_names: tuple[str, ...], blobs: list[bytes] | None = None):
        self._services = tuple(service_names) + (SERVICE_NAME,)
        self._files = {f.name: f for f in map(_File, load_descriptors() if blobs is None
                                              else blobs)}

    def _closure(self, name: str) -> list[bytes]:
        """``name``'s file and its transitive dependencies, in the JAX
        servicer's order (a depth-first stack)."""
        out, seen, stack = [], set(), [name]
        while stack:
            f = self._files[stack.pop()]
            if f.name in seen:
                continue
            seen.add(f.name)
            out.append(f.blob)
            stack.extend(f.deps)
        return out

    def _find_symbol(self, symbol: str) -> str:
        """The file that defines ``symbol``; KeyError if none does."""
        for f in self._files.values():
            if symbol in f.symbols:
                return f.name
        parent, _, leaf = symbol.rpartition(".")
        for f in self._files.values():
            if leaf in f.members.get(parent, ()):
                return f.name
        raise KeyError(symbol)

    def _find_message(self, name: str) -> str:
        for f in self._files.values():
            if name in f.messages:
                return name
        raise KeyError(name)

    def respond(self, request: bytes) -> bytes:
        """One ServerReflectionResponse for one ServerReflectionRequest.
        Raises ValueError on malformed request bytes."""
        host, kind, arg = "", None, None
        for number, wire, value in _fields(request):
            if number == 1 and wire == 2:
                host = value.decode()
            elif number in _REQUEST_KINDS and wire == 2:
                kind, arg = _REQUEST_KINDS[number], value
        original = _string(1, host) + (_delimited(_varint(_number_of(kind) << 3 | 2), arg)
                                       if kind is not None else b"")
        head = _string(1, host) + _delimited(b"\x12", original)
        try:
            if kind == "list_services":
                body = b"".join(_delimited(b"\x0a", _string(1, s)) for s in self._services)
                return head + _delimited(b"\x32", body)
            if kind == "file_by_filename":
                name = arg.decode()
                if name not in self._files:
                    raise KeyError(name)
                return head + _file_response(self._closure(name))
            if kind == "file_containing_symbol":
                return head + _file_response(self._closure(self._find_symbol(arg.decode())))
            if kind == "file_containing_extension":
                containing = ""
                for number, wire, value in _fields(arg):
                    if number == 1 and wire == 2:
                        containing = value.decode()
                self._find_message(containing)
                raise KeyError(containing)  # no file here declares an extension
            if kind == "all_extension_numbers_of_type":
                base = self._find_message(arg.decode())
                return head + _delimited(b"\x2a", _string(1, base))
            error = _varint(1 << 3) + _varint(_UNIMPLEMENTED) + _string(2, "no message_request set")
        except KeyError:
            error = (_varint(1 << 3) + _varint(_NOT_FOUND)
                     + _string(2, f"{kind} target not found"))
        return head + _delimited(b"\x3a", error)


def _number_of(kind: str) -> int:
    return next(n for n, k in _REQUEST_KINDS.items() if k == kind)


def _string(number: int, value: str) -> bytes:
    """A proto3 string field; empty writes nothing."""
    return _delimited(_varint(number << 3 | 2), value.encode()) if value else b""


def _file_response(blobs: list[bytes]) -> bytes:
    return _delimited(b"\x22", b"".join(_delimited(b"\x0a", b) for b in blobs))


def register(server, service_names: tuple[str, ...]) -> None:
    """Register ServerReflectionInfo (bytes in, bytes out) for
    ``service_names`` on ``server`` (a ``grpc_wire.Server``): a stream
    handler answering each request as it arrives."""
    from igaming_platform_tpu_torch.serve import grpc_wire

    service = ReflectionService(service_names)

    def info(request_iterator, context):
        for request in request_iterator:
            yield service.respond(request)

    server.add_service(SERVICE_NAME, {"ServerReflectionInfo": grpc_wire.stream_stream(info)})
