"""Channel-based wire protocol (the club-unison analog; the port's copy of
``fleetflow_tpu/cp/protocol.py``).

The reference's transport is QUIC (quinn) with named channels, id-correlated
request/response, fire-and-forget events, an identity handshake, and MeshCa
mTLS (SURVEY.md §2.10 comms row; server.rs:101-162, cp_client.rs:18-105).
This build keeps the exact message shapes over asyncio TCP, optionally
wrapped in TLS from cp/cert.py:

  frame    = 4-byte big-endian length ‖ utf-8 JSON body (1 MiB cap)
  hello    = {"type":"hello","identity":str,"token":str|None,
              "channels":[...]}            client -> server, once
  welcome  = {"type":"welcome","server":str}
  request  = {"type":"request","id":int,"channel":str,"method":str,
              "payload":{}}
  response = {"type":"response","id":int,"payload":{},"error":str|None}
  event    = {"type":"event","channel":str,"method":str,"payload":{}}

Requests flow BOTH ways on a connection (the agent channel is duplex: the
CP sends commands to agents, handlers/agent.rs:129-159), so both endpoints
run the same dispatch loop; only the handshake differs.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import ssl
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

from ..core.errors import ControlPlaneError
from ..obs import get_logger, kv

log = get_logger("cp.protocol")

__all__ = ["Connection", "ProtocolServer", "ProtocolClient", "RpcError",
           "MAX_FRAME"]

MAX_FRAME = 1 << 20


class RpcError(ControlPlaneError):
    pass


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    size = int.from_bytes(header, "big")
    if size > MAX_FRAME:
        raise RpcError(f"frame too large: {size}")
    try:
        body = await reader.readexactly(size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return json.loads(body)


def encode_frame(msg: dict) -> bytes:
    body = json.dumps(msg, separators=(",", ":")).encode()
    if len(body) > MAX_FRAME:
        raise RpcError(f"frame too large: {len(body)}")
    return len(body).to_bytes(4, "big") + body


# Handler signature: async (conn, method, payload) -> payload
Handler = Callable[["Connection", str, dict], Awaitable[Any]]
# Event handler: async (conn, method, payload) -> None
EventHandler = Callable[["Connection", str, dict], Awaitable[None]]


@dataclass(eq=False)  # identity semantics: connections live in sets/dicts
class Connection:
    """One live peer connection; symmetric request/response + events."""
    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    identity: str = "?"
    # Claims attached by the server's authenticate callback (None when the
    # server runs without auth or the callback returns a bare bool); channel
    # handlers enforce per-method permissions against this.
    claims: Optional[object] = None
    handlers: dict[str, Handler] = field(default_factory=dict)
    event_handlers: dict[str, EventHandler] = field(default_factory=dict)
    _ids: itertools.count = field(default_factory=lambda: itertools.count(1))
    _pending: dict[int, asyncio.Future] = field(default_factory=dict)
    _tasks: set = field(default_factory=set)   # strong refs: loop holds weak
    _closed: bool = False
    on_close: Optional[Callable[["Connection"], Awaitable[None]]] = None
    # the server's welcome frame (client side): carries the peer's
    # replication role/epoch when the server advertises them
    welcome: dict = field(default_factory=dict)

    def _spawn(self, coro) -> asyncio.Task:
        """ensure_future with a strong reference: the event loop only keeps
        weak refs to tasks, so an unreferenced in-flight dispatch could be
        garbage-collected mid-execution."""
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _send(self, msg: dict) -> None:
        if self._closed:
            raise RpcError("connection closed")
        self.writer.write(encode_frame(msg))
        await self.writer.drain()

    async def request(self, channel: str, method: str, payload: dict | None = None,
                      timeout: float = 60.0) -> dict:
        """Id-correlated request; raises RpcError on remote error/timeout."""
        mid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        try:
            await self._send({"type": "request", "id": mid, "channel": channel,
                              "method": method, "payload": payload or {}})
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise RpcError(
                f"request {channel}.{method} timed out after {timeout}s") from None
        finally:
            self._pending.pop(mid, None)

    async def send_event(self, channel: str, method: str,
                         payload: dict | None = None) -> None:
        """Fire-and-forget (club-unison send_event)."""
        await self._send({"type": "event", "channel": channel,
                          "method": method, "payload": payload or {}})

    async def run(self) -> None:
        """Dispatch loop: route responses to futures, requests to channel
        handlers, events to event handlers. Returns on disconnect."""
        try:
            while True:
                msg = await read_frame(self.reader)
                if msg is None:
                    break
                t = msg.get("type")
                if t == "response":
                    fut = self._pending.get(msg.get("id"))
                    if fut is not None and not fut.done():
                        if msg.get("error"):
                            fut.set_exception(RpcError(msg["error"]))
                        else:
                            fut.set_result(msg.get("payload", {}))
                elif t == "request":
                    self._spawn(self._dispatch(msg))
                elif t == "event":
                    handler = self.event_handlers.get(msg.get("channel", ""))
                    if handler is not None:
                        self._spawn(handler(
                            self, msg.get("method", ""), msg.get("payload", {})))
        finally:
            await self.close()

    async def _dispatch(self, msg: dict) -> None:
        channel, method = msg.get("channel", ""), msg.get("method", "")
        handler = self.handlers.get(channel)
        resp: dict = {"type": "response", "id": msg.get("id")}
        if handler is None:
            resp["error"] = f"unknown channel {channel!r}"
        else:
            try:
                resp["payload"] = await handler(self, method, msg.get("payload", {}))
            except Exception as e:  # handler errors become remote RpcErrors
                resp["error"] = f"{type(e).__name__}: {e}"
        try:
            await self._send(resp)
        except (RpcError, ConnectionResetError):
            pass

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(RpcError("connection closed"))
        self._pending.clear()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass
        if self.on_close is not None:
            await self.on_close(self)


class ProtocolServer:
    """Accepts connections, performs the hello/welcome handshake, then runs
    the symmetric dispatch loop per connection."""

    def __init__(self, *, name: str = "cp",
                 authenticate: Optional[Callable[[str, Optional[str]], bool]] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 handshake_timeout: float = 10.0,
                 welcome_extra: Optional[Callable[[], dict]] = None):
        self.name = name
        self.authenticate = authenticate
        self.ssl_context = ssl_context
        self.handshake_timeout = handshake_timeout
        # extra key/values merged into every welcome frame — the CP
        # advertises its replication role and fencing epoch here, so a
        # client can refuse a zombie ex-primary BEFORE sending anything
        # (docs/guide/13-cp-replication.md)
        self.welcome_extra = welcome_extra
        self.handlers: dict[str, Handler] = {}
        self.event_handlers: dict[str, EventHandler] = {}
        self.connections: set[Connection] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self.on_connect: Optional[Callable[[Connection, dict], Awaitable[None]]] = None
        self.on_disconnect: Optional[Callable[[Connection], Awaitable[None]]] = None

    def register_channel(self, channel: str, handler: Handler,
                         event_handler: Optional[EventHandler] = None) -> None:
        self.handlers[channel] = handler
        if event_handler is not None:
            self.event_handlers[channel] = event_handler

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(
            self._accept, host, port, ssl=self.ssl_context)
        sock = self._server.sockets[0].getsockname()
        return sock[0], sock[1]

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        # pre-auth phase is bounded: an idle or malformed client must not
        # pin an accept coroutine forever
        try:
            hello = await asyncio.wait_for(read_frame(reader),
                                           self.handshake_timeout)
        except (asyncio.TimeoutError, RpcError, json.JSONDecodeError):
            writer.close()
            return
        if not hello or hello.get("type") != "hello":
            writer.close()
            return
        identity = str(hello.get("identity", "?"))
        verdict = (self.authenticate(identity, hello.get("token"))
                   if self.authenticate else True)
        if not verdict:
            log.warning("rejected %s", kv(identity=identity,
                                          reason="unauthorized"))
            writer.write(encode_frame({"type": "error", "error": "unauthorized"}))
            await writer.drain()
            writer.close()
            return
        log.info("connected %s", kv(identity=identity,
                                    peers=len(self.connections) + 1))
        conn = Connection(reader=reader, writer=writer, identity=identity,
                          # a truthy non-bool verdict is the peer's Claims
                          claims=None if verdict is True else verdict,
                          handlers=self.handlers,
                          event_handlers=self.event_handlers)
        self.connections.add(conn)
        conn.on_close = self._forget
        try:
            welcome = {"type": "welcome", "server": self.name}
            if self.welcome_extra is not None:
                welcome.update(self.welcome_extra())
            await conn._send(welcome)
            if self.on_connect is not None:
                await self.on_connect(conn, hello)
        except Exception:
            await conn.close()   # client reset mid-welcome: don't leak
            return
        await conn.run()

    async def _forget(self, conn: Connection) -> None:
        self.connections.discard(conn)
        log.info("disconnected %s", kv(identity=conn.identity,
                                       peers=len(self.connections)))
        if self.on_disconnect is not None:
            await self.on_disconnect(conn)

    async def stop(self) -> None:
        # close live connections BEFORE wait_closed(): since 3.12,
        # Server.wait_closed waits for every handler coroutine to finish,
        # and those only return once their connection closes
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()


class ProtocolClient:
    """Client side: connect + handshake; exposes the same Connection."""

    @staticmethod
    async def connect(host: str, port: int, *, identity: str,
                      token: Optional[str] = None,
                      ssl_context: Optional[ssl.SSLContext] = None,
                      handlers: Optional[dict[str, Handler]] = None,
                      event_handlers: Optional[dict[str, EventHandler]] = None,
                      ) -> tuple[Connection, asyncio.Task]:
        reader, writer = await asyncio.open_connection(
            host, port, ssl=ssl_context)
        conn = Connection(reader=reader, writer=writer, identity=identity,
                          handlers=handlers or {},
                          event_handlers=event_handlers or {})
        try:
            writer.write(encode_frame({
                "type": "hello", "identity": identity, "token": token,
                "channels": sorted((handlers or {}).keys())}))
            await writer.drain()
            welcome = await read_frame(reader)
            if not welcome:
                raise RpcError("connection closed during handshake")
            if welcome.get("type") == "error":
                raise RpcError(welcome.get("error", "handshake rejected"))
            if welcome.get("type") != "welcome":
                raise RpcError(f"unexpected handshake reply: {welcome}")
            conn.welcome = welcome
        except BaseException:
            writer.close()   # failed handshake must not leak the socket
            raise
        task = asyncio.ensure_future(conn.run())
        return conn, task
