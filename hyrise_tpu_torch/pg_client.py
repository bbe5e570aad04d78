"""A small client of the PostgreSQL wire protocol (version 3.0, text
format), for checking the server: the startup, SimpleQuery, and the
extended protocol's Parse / Bind / Describe / Execute / Sync. It keeps every
message an answer sends, as (tag, body) pairs, so that a check can look at
each of them; the functions below decode them.

It reads through a buffer. A client that runs as a thread of the server's
own process would otherwise call recv once a message and hand the
interpreter lock back and forth with the server's thread tens of thousands
of times an answer.

    c = PgClient(port)
    c.startup()
    msgs = c.query("SELECT 1")
    typed_rows(msgs), command_tags(msgs)
"""

from __future__ import annotations

import socket
import struct
from typing import List, Optional, Sequence, Tuple

OID_INT = (20, 21, 23)
OID_FLOAT = (700, 701)

Message = Tuple[bytes, bytes]


class PgClient:
    def __init__(self, port: int, host: str = "127.0.0.1", timeout: float = 60.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb", buffering=1 << 20)

    def startup(self, user: str = "check") -> List[Message]:
        body = struct.pack("!I", 196608) + b"user\x00" + user.encode() + b"\x00\x00"
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        msgs = self.read_until(b"Z")
        if not any(t == b"R" for t, _ in msgs):
            raise ConnectionError(f"no authentication message in {msgs}")
        return msgs

    def send(self, tag: bytes, body: bytes = b"") -> None:
        self.sock.sendall(tag + struct.pack("!I", len(body) + 4) + body)

    def query(self, sql: str) -> List[Message]:
        """SimpleQuery: every message up to ReadyForQuery."""
        self.send(b"Q", sql.encode() + b"\x00")
        return self.read_until(b"Z")

    def parse(self, sql: str, oids: Sequence[int] = (), name: bytes = b"") -> None:
        body = name + b"\x00" + sql.encode() + b"\x00" + struct.pack("!H", len(oids))
        self.send(b"P", body + b"".join(struct.pack("!I", o) for o in oids))

    def bind(self, params: Sequence[object] = (), statement: bytes = b"",
             portal: bytes = b"") -> None:
        """Bind with every parameter as text (None is NULL) and text results."""
        body = portal + b"\x00" + statement + b"\x00" + struct.pack("!HH", 0, len(params))
        for p in params:
            if p is None:
                body += struct.pack("!i", -1)
            else:
                enc = str(p).encode()
                body += struct.pack("!i", len(enc)) + enc
        self.send(b"B", body + struct.pack("!H", 0))

    def describe(self, kind: bytes, name: bytes = b"") -> None:
        self.send(b"D", kind + name + b"\x00")

    def execute(self, portal: bytes = b"") -> None:
        self.send(b"E", portal + b"\x00" + struct.pack("!I", 0))

    def sync(self) -> List[Message]:
        """Sync: every message since the last answer, up to ReadyForQuery."""
        self.send(b"S")
        return self.read_until(b"Z")

    def read_msg(self) -> Message:
        tag = self._exact(1)
        return tag, self._exact(struct.unpack("!I", self._exact(4))[0] - 4)

    def read_until(self, stop: bytes) -> List[Message]:
        out = []
        while True:
            out.append(self.read_msg())
            if out[-1][0] == stop:
                return out

    def _exact(self, n: int) -> bytes:
        data = self.rfile.read(n)
        if len(data) != n:
            raise ConnectionError("the server closed the session")
        return data

    def close(self) -> None:
        self.send(b"X")
        self.rfile.close()
        self.sock.close()


def tags(msgs: List[Message]) -> List[bytes]:
    return [t for t, _ in msgs]


def command_tags(msgs: List[Message]) -> List[str]:
    return [b.rstrip(b"\x00").decode() for t, b in msgs if t == b"C"]


def row_description(msgs: List[Message]) -> List[Tuple[str, int]]:
    """[(name, type oid)] of the first RowDescription."""
    body = next(b for t, b in msgs if t == b"T")
    out, off = [], 2
    for _ in range(struct.unpack("!H", body[:2])[0]):
        end = body.index(b"\x00", off)
        out.append((body[off:end].decode(), struct.unpack("!I", body[end + 7:end + 11])[0]))
        off = end + 19
    return out


def text_rows(msgs: List[Message]) -> List[Tuple[Optional[str], ...]]:
    """The DataRows as text (None for NULL)."""
    out = []
    for t, body in msgs:
        if t != b"D":
            continue
        off, row = 2, []
        for _ in range(struct.unpack("!H", body[:2])[0]):
            n = struct.unpack("!i", body[off:off + 4])[0]
            off += 4
            if n < 0:
                row.append(None)
            else:
                row.append(body[off:off + n].decode())
                off += n
        out.append(tuple(row))
    return out


def typed_rows(msgs: List[Message]) -> List[tuple]:
    """The DataRows as values of their RowDescription's types. An int's text
    must be its canonical form, so that equal values mean equal bytes."""
    oids = [o for _, o in row_description(msgs)]
    out = []
    for row in text_rows(msgs):
        vals = []
        for text, oid in zip(row, oids):
            if text is None:
                vals.append(None)
            elif oid in OID_INT:
                if str(int(text)) != text:
                    raise ValueError(f"{text!r} is not an int's canonical text")
                vals.append(int(text))
            elif oid in OID_FLOAT:
                vals.append(float(text))
            else:
                vals.append(text)
        out.append(tuple(vals))
    return out
