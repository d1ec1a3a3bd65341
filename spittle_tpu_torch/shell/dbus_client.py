"""Minimal pure-Python D-Bus peer (client + object export).

Port of spittle_tpu/shell/dbus_client.py.

Just enough of the D-Bus wire protocol to implement a real
StatusNotifierItem tray (shell/tray_sni.py) without external
dependencies: EXTERNAL auth over the session bus unix socket, message
marshal/unmarshal for the common types (y b n q i u x t d s o g v a
struct dict-entry), blocking method calls, signal emission, and object
export with Introspect/Properties handling on a reader thread.

The reference gets its tray from Tauri's libappindicator binding
(reference: src-tauri/src/tray.rs:9-18); this speaks the same
freedesktop protocol the desktop actually uses, from scratch.

Wire format reference: dbus-specification (marshalling + message
format). Alignment: each type aligns to its own size; structs and
dict-entries to 8; arrays store the byte length of their content,
excluding the padding that aligns the first element.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("dbus")

MSG_METHOD_CALL = 1
MSG_METHOD_RETURN = 2
MSG_ERROR = 3
MSG_SIGNAL = 4

H_PATH = 1
H_INTERFACE = 2
H_MEMBER = 3
H_ERROR_NAME = 4
H_REPLY_SERIAL = 5
H_DESTINATION = 6
H_SENDER = 7
H_SIGNATURE = 8

_ALIGN = {
    "y": 1, "b": 4, "n": 2, "q": 2, "i": 4, "u": 4, "x": 8, "t": 8,
    "d": 8, "s": 4, "o": 4, "g": 1, "a": 4, "(": 8, "{": 8, "v": 1,
    "h": 4,
}


def _split_signature(sig: str) -> List[str]:
    """'a{sv}si' -> ['a{sv}', 's', 'i'] (one complete type each)."""
    out = []
    i = 0
    while i < len(sig):
        start = i
        while sig[i] == "a":
            i += 1
        if sig[i] == "(":
            depth = 1
            i += 1
            while depth:
                depth += {"(": 1, ")": -1}.get(sig[i], 0)
                i += 1
        elif sig[i] == "{":
            depth = 1
            i += 1
            while depth:
                depth += {"{": 1, "}": -1}.get(sig[i], 0)
                i += 1
        else:
            i += 1
        out.append(sig[start:i])
    return out


class Variant:
    """Explicitly-typed value for 'v' slots: Variant('s', 'hello')."""

    def __init__(self, signature: str, value: Any):
        self.signature = signature
        self.value = value

    def __repr__(self):
        return f"Variant({self.signature!r}, {self.value!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Variant)
            and other.signature == self.signature
            and other.value == self.value
        )


class Marshaller:
    def __init__(self):
        self.buf = io.BytesIO()

    def pos(self) -> int:
        return self.buf.tell()

    def pad(self, align: int) -> None:
        rem = self.buf.tell() % align
        if rem:
            self.buf.write(b"\0" * (align - rem))

    def write(self, sig: str, values: Tuple) -> None:
        types = _split_signature(sig)
        assert len(types) == len(values), (sig, values)
        for t, v in zip(types, values):
            self._one(t, v)

    def _one(self, t: str, v: Any) -> None:
        self.pad(_ALIGN[t[0]])
        if t == "y":
            self.buf.write(struct.pack("B", v))
        elif t == "b":
            self.buf.write(struct.pack("<I", 1 if v else 0))
        elif t == "n":
            self.buf.write(struct.pack("<h", v))
        elif t == "q":
            self.buf.write(struct.pack("<H", v))
        elif t == "i":
            self.buf.write(struct.pack("<i", v))
        elif t in ("u", "h"):
            self.buf.write(struct.pack("<I", v))
        elif t == "x":
            self.buf.write(struct.pack("<q", v))
        elif t == "t":
            self.buf.write(struct.pack("<Q", v))
        elif t == "d":
            self.buf.write(struct.pack("<d", v))
        elif t in ("s", "o"):
            raw = v.encode()
            self.buf.write(struct.pack("<I", len(raw)) + raw + b"\0")
        elif t == "g":
            raw = v.encode()
            self.buf.write(struct.pack("B", len(raw)) + raw + b"\0")
        elif t == "v":
            var = v if isinstance(v, Variant) else _infer_variant(v)
            self._one("g", var.signature)
            self._one(var.signature, var.value)
        elif t.startswith("a"):
            inner = t[1:]
            # length placeholder, then pad to the element alignment,
            # then content; length = content bytes only.
            len_pos = self.buf.tell()
            self.buf.write(b"\0\0\0\0")
            self.pad(_ALIGN[inner[0]])
            start = self.buf.tell()
            if inner.startswith("{"):
                ksig, vsig = _split_signature(inner[1:-1])
                items = v.items() if isinstance(v, dict) else v
                for key, val in items:
                    self.pad(8)
                    self._one(ksig, key)
                    self._one(vsig, val)
            else:
                for item in v:
                    self._one(inner, item)
            end = self.buf.tell()
            self.buf.seek(len_pos)
            self.buf.write(struct.pack("<I", end - start))
            self.buf.seek(end)
        elif t.startswith("("):
            inner_types = _split_signature(t[1:-1])
            assert len(inner_types) == len(v), (t, v)
            for it, iv in zip(inner_types, v):
                self._one(it, iv)
        else:
            raise ValueError(f"unsupported type {t!r}")

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


def _infer_variant(v: Any) -> Variant:
    if isinstance(v, bool):
        return Variant("b", v)
    if isinstance(v, int):
        return Variant("i", v)
    if isinstance(v, float):
        return Variant("d", v)
    if isinstance(v, str):
        return Variant("s", v)
    raise ValueError(f"cannot infer variant type for {v!r}")


class Unmarshaller:
    def __init__(self, data: bytes, offset: int = 0, little: bool = True):
        self.data = data
        self.pos = offset
        self.e = "<" if little else ">"

    def pad(self, align: int) -> None:
        rem = self.pos % align
        if rem:
            self.pos += align - rem

    def read(self, sig: str) -> List[Any]:
        return [self._one(t) for t in _split_signature(sig)]

    def _take(self, fmt: str, size: int):
        v = struct.unpack_from(self.e + fmt, self.data, self.pos)[0]
        self.pos += size
        return v

    def _one(self, t: str) -> Any:
        self.pad(_ALIGN[t[0]])
        if t == "y":
            return self._take("B", 1)
        if t == "b":
            return bool(self._take("I", 4))
        if t == "n":
            return self._take("h", 2)
        if t == "q":
            return self._take("H", 2)
        if t == "i":
            return self._take("i", 4)
        if t in ("u", "h"):
            return self._take("I", 4)
        if t == "x":
            return self._take("q", 8)
        if t == "t":
            return self._take("Q", 8)
        if t == "d":
            return self._take("d", 8)
        if t in ("s", "o"):
            n = self._take("I", 4)
            v = self.data[self.pos:self.pos + n].decode()
            self.pos += n + 1
            return v
        if t == "g":
            n = self._take("B", 1)
            v = self.data[self.pos:self.pos + n].decode()
            self.pos += n + 1
            return v
        if t == "v":
            sig = self._one("g")
            return Variant(sig, self._one(sig))
        if t.startswith("a"):
            inner = t[1:]
            n = self._take("I", 4)
            self.pad(_ALIGN[inner[0]])
            end = self.pos + n
            if inner.startswith("{"):
                ksig, vsig = _split_signature(inner[1:-1])
                out: Dict = {}
                while self.pos < end:
                    self.pad(8)
                    k = self._one(ksig)
                    out[k] = self._one(vsig)
                return out
            items = []
            while self.pos < end:
                items.append(self._one(inner))
            return items
        if t.startswith("("):
            return tuple(self._one(it) for it in _split_signature(t[1:-1]))
        raise ValueError(f"unsupported type {t!r}")


def _build_message(
    msg_type: int,
    serial: int,
    fields: List[Tuple[int, Variant]],
    body_sig: str = "",
    body_values: Tuple = (),
) -> bytes:
    body = b""
    if body_sig:
        m = Marshaller()
        m.write(body_sig, body_values)
        body = m.getvalue()
        fields = fields + [(H_SIGNATURE, Variant("g", body_sig))]
    m = Marshaller()
    m.write("yyyy", (ord("l"), msg_type, 0, 1))
    m.write("uu", (len(body), serial))
    m._one("a(yv)", [(f, v) for f, v in fields])
    m.pad(8)
    return m.getvalue() + body


class Message:
    def __init__(self, msg_type, serial, fields, body):
        self.type = msg_type
        self.serial = serial
        self.fields = fields
        self.body = body

    @property
    def path(self):
        return self.fields.get(H_PATH)

    @property
    def interface(self):
        return self.fields.get(H_INTERFACE)

    @property
    def member(self):
        return self.fields.get(H_MEMBER)

    @property
    def sender(self):
        return self.fields.get(H_SENDER)

    @property
    def reply_serial(self):
        return self.fields.get(H_REPLY_SERIAL)

    @property
    def signature(self):
        return self.fields.get(H_SIGNATURE, "")


class DBusConnection:
    """One session-bus connection: calls out, serves exported objects."""

    def __init__(self, address: Optional[str] = None):
        address = address or os.environ.get("DBUS_SESSION_BUS_ADDRESS", "")
        path = None
        abstract = None
        for part in address.split(";")[0].split(","):
            if part.startswith("unix:path="):
                path = part[len("unix:path="):]
            elif part.startswith("path="):
                path = part[len("path="):]
            elif part.startswith("unix:abstract="):
                abstract = part[len("unix:abstract="):]
            elif part.startswith("abstract="):
                abstract = part[len("abstract="):]
        if path is None and abstract is None:
            raise ConnectionError(f"unsupported bus address: {address!r}")
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.connect(path if path is not None else "\0" + abstract)
        self._auth()
        self._serial = 0
        self._serial_lock = threading.Lock()
        # One message = one atomic write: call/emit_signal run on app
        # threads while _reply runs on the reader thread; unserialized
        # sendall could interleave frames and corrupt the stream.
        self._write_lock = threading.Lock()
        self._replies: Dict[int, Any] = {}
        self._reply_cv = threading.Condition()
        self._buf = b""
        # exported objects: path -> {(interface, member): handler}
        self._objects: Dict[str, "ExportedObject"] = {}
        self._signal_handlers: List[Callable[[Message], None]] = []
        self._closed = threading.Event()
        self._reader = threads.spawn(self._read_loop, name="dbus-reader")
        self.unique_name = self.call(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "Hello",
        )[0]

    def _auth(self) -> None:
        uid_hex = str(os.getuid()).encode().hex().encode()
        self.sock.sendall(b"\0AUTH EXTERNAL " + uid_hex + b"\r\n")
        line = b""
        while not line.endswith(b"\r\n"):
            line += self.sock.recv(1)
        if not line.startswith(b"OK"):
            raise ConnectionError(f"dbus auth failed: {line!r}")
        self.sock.sendall(b"BEGIN\r\n")

    def close(self) -> None:
        self._closed.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def _next_serial(self) -> int:
        with self._serial_lock:
            self._serial += 1
            return self._serial

    # -- outgoing --------------------------------------------------------

    def call(
        self,
        destination: str,
        path: str,
        interface: str,
        member: str,
        signature: str = "",
        args: Tuple = (),
        timeout: float = 10.0,
    ) -> Tuple:
        serial = self._next_serial()
        fields = [
            (H_PATH, Variant("o", path)),
            (H_MEMBER, Variant("s", member)),
            (H_INTERFACE, Variant("s", interface)),
            (H_DESTINATION, Variant("s", destination)),
        ]
        data = _build_message(MSG_METHOD_CALL, serial, fields,
                              signature, args)
        self._send(data)
        with self._reply_cv:
            ok = self._reply_cv.wait_for(
                lambda: serial in self._replies, timeout=timeout
            )
            if not ok:
                raise TimeoutError(f"no reply to {member}")
            reply = self._replies.pop(serial)
        if isinstance(reply, Exception):
            raise reply
        return reply

    def emit_signal(
        self, path: str, interface: str, member: str,
        signature: str = "", args: Tuple = (),
    ) -> None:
        fields = [
            (H_PATH, Variant("o", path)),
            (H_MEMBER, Variant("s", member)),
            (H_INTERFACE, Variant("s", interface)),
        ]
        data = _build_message(MSG_SIGNAL, self._next_serial(), fields,
                              signature, args)
        self._send(data)

    def request_name(self, name: str) -> int:
        return self.call(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "RequestName", "su", (name, 0),
        )[0]

    def add_match(self, rule: str) -> None:
        self.call(
            "org.freedesktop.DBus", "/org/freedesktop/DBus",
            "org.freedesktop.DBus", "AddMatch", "s", (rule,),
        )

    def on_signal(self, handler: Callable[[Message], None]) -> None:
        self._signal_handlers.append(handler)

    # -- object export ---------------------------------------------------

    def export(self, path: str, obj: "ExportedObject") -> None:
        obj.connection = self
        obj.path = path
        self._objects[path] = obj

    # -- incoming --------------------------------------------------------

    def _read_loop(self) -> None:
        while not self._closed.is_set():
            try:
                chunk = self.sock.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            self._buf += chunk
            while True:
                msg, consumed = self._try_parse(self._buf)
                if msg is None:
                    break
                self._buf = self._buf[consumed:]
                try:
                    self._handle(msg)
                except Exception:
                    _log.exception("dbus message handling failed")

    @staticmethod
    def _try_parse(buf: bytes) -> Tuple[Optional[Message], int]:
        if len(buf) < 16:
            return None, 0
        little = buf[0:1] == b"l"
        e = "<" if little else ">"
        body_len, serial, fields_len = struct.unpack_from(e + "III", buf, 4)
        header_len = 16 + fields_len
        total = header_len + (-header_len % 8) + body_len
        if len(buf) < total:
            return None, 0
        u = Unmarshaller(buf, 12, little)
        raw_fields = u._one("a(yv)")
        fields = {f: v.value for f, v in raw_fields}
        body_start = header_len + (-header_len % 8)
        sig = fields.get(H_SIGNATURE, "")
        body: Tuple = ()
        if sig:
            bu = Unmarshaller(buf, body_start, little)
            body = tuple(bu.read(sig))
        return Message(buf[1], serial, fields, body), total

    def _handle(self, msg: Message) -> None:
        if msg.type in (MSG_METHOD_RETURN, MSG_ERROR):
            rs = msg.reply_serial
            with self._reply_cv:
                if msg.type == MSG_ERROR:
                    name = msg.fields.get(H_ERROR_NAME, "org.freedesktop.DBus.Error.Failed")
                    self._replies[rs] = RuntimeError(
                        f"{name}: {msg.body[0] if msg.body else ''}"
                    )
                else:
                    self._replies[rs] = msg.body
                self._reply_cv.notify_all()
            return
        if msg.type == MSG_SIGNAL:
            for h in list(self._signal_handlers):
                h(msg)
            return
        if msg.type == MSG_METHOD_CALL:
            obj = self._objects.get(msg.path)
            if obj is None:
                self._reply_error(msg, "org.freedesktop.DBus.Error.UnknownObject")
                return
            obj.dispatch(msg)

    def _send(self, data: bytes) -> None:
        with self._write_lock:
            self.sock.sendall(data)

    def _reply(self, msg: Message, signature: str = "",
               values: Tuple = ()) -> None:
        fields = [(H_REPLY_SERIAL, Variant("u", msg.serial))]
        if msg.sender:
            fields.append((H_DESTINATION, Variant("s", msg.sender)))
        data = _build_message(MSG_METHOD_RETURN, self._next_serial(),
                              fields, signature, values)
        self._send(data)

    def _reply_error(self, msg: Message, name: str, text: str = "") -> None:
        fields = [
            (H_REPLY_SERIAL, Variant("u", msg.serial)),
            (H_ERROR_NAME, Variant("s", name)),
        ]
        if msg.sender:
            fields.append((H_DESTINATION, Variant("s", msg.sender)))
        data = _build_message(MSG_ERROR, self._next_serial(), fields,
                              "s", (text or name,))
        self._send(data)


class ExportedObject:
    """An object served on the bus: methods + properties per interface.

    methods: {(interface, member): fn(*body) -> (signature, values)}
    properties: {interface: {name: Variant}}
    """

    def __init__(self):
        self.methods: Dict[Tuple[str, str], Callable] = {}
        self.properties: Dict[str, Dict[str, Variant]] = {}
        self.connection: Optional[DBusConnection] = None
        self.path: str = "/"

    def dispatch(self, msg: Message) -> None:
        conn = self.connection
        iface, member = msg.interface, msg.member
        if iface == "org.freedesktop.DBus.Properties":
            if member == "Get":
                target_iface, prop = msg.body
                var = self.properties.get(target_iface, {}).get(prop)
                if var is None:
                    conn._reply_error(
                        msg, "org.freedesktop.DBus.Error.UnknownProperty")
                    return
                conn._reply(msg, "v", (var,))
                return
            if member == "GetAll":
                (target_iface,) = msg.body
                conn._reply(
                    msg, "a{sv}",
                    (self.properties.get(target_iface, {}),),
                )
                return
            if member == "Set":
                conn._reply(msg)
                return
        if iface == "org.freedesktop.DBus.Introspectable" and member == "Introspect":
            conn._reply(msg, "s", (self.introspect_xml(),))
            return
        fn = self.methods.get((iface, member)) or self.methods.get(
            ("", member)
        )
        if fn is None:
            conn._reply_error(msg, "org.freedesktop.DBus.Error.UnknownMethod",
                              f"{iface}.{member}")
            return
        try:
            result = fn(*msg.body)
        except Exception as e:  # noqa: BLE001 - bus boundary
            _log.exception("exported method %s.%s failed", iface, member)
            conn._reply_error(msg, "org.freedesktop.DBus.Error.Failed", str(e))
            return
        if result is None:
            conn._reply(msg)
        else:
            sig, values = result
            conn._reply(msg, sig, values)

    def introspect_xml(self) -> str:
        ifaces = set(self.properties) | {i for i, _ in self.methods if i}
        parts = ['<node>']
        for i in sorted(ifaces):
            parts.append(f'  <interface name="{i}"/>')
        parts.append("</node>")
        return "\n".join(parts)
