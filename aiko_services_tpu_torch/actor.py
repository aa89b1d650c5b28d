# Actor layer: message → method-call RPC over per-actor mailboxes.
#
# The port's own copy of aiko_services_tpu/actor.py:
#   * ActorMessage — deferred method invocation (target, command, args);
#   * Actor — a Service with `control` and `in` mailboxes (control drains
#     first), inbound payloads (S-expressions, or binary wire envelopes
#     whose tensors arrive out of band) dispatched as method calls;
#     built-in EC share with lifecycle / log_level;
#   * get_remote_proxy — reflects a protocol class's public methods into a
#     proxy whose calls serialize (transport/wire.py encode_rpc: a binary
#     envelope when an argument holds an array or tensor and the transport
#     carries bytes, S-expression text otherwise) and publish to the
#     target's `in` topic (the "function call → message" half of the RPC).

from __future__ import annotations

import inspect
import logging
import time

from .observe import tracing
from .service import Service, ServiceProtocol
from .share import ECProducer, ServicesCache
from .transport import wire
from .utils import TransportLoggingHandler, get_logger, parse

__all__ = ["ActorMessage", "Actor", "ActorDiscovery", "get_remote_proxy",
           "get_public_methods", "PROTOCOL_ACTOR"]

PROTOCOL_ACTOR = ServiceProtocol("actor")


class ActorMessage:
    __slots__ = ("target", "command", "arguments", "trace")

    def __init__(self, target, command: str, arguments, trace=None):
        self.target = target
        self.command = command
        self.arguments = arguments
        # trace context the message arrived under (envelope header /
        # sexpr marker): activated for the duration of the call, so the
        # handler — and anything it spawns — inherits the caller's
        # trace id and deadline
        self.trace = trace

    def invoke(self, logger=None) -> None:
        method = getattr(self.target, self.command, None)
        if method is None or self.command.startswith("_") \
                or not callable(method):
            if logger:
                logger.warning("actor %s: no method %r",
                               getattr(self.target, "name", "?"),
                               self.command)
            return
        try:
            with tracing.activate(self.trace):
                method(*self.arguments)
        except Exception:
            if logger:
                logger.exception("actor %s: %s%r raised",
                                 getattr(self.target, "name", "?"),
                                 self.command, tuple(self.arguments))


class Actor(Service):
    def __init__(self, runtime, name: str, protocol=None, tags=None,
                 share: dict | None = None):
        super().__init__(runtime, name, protocol or PROTOCOL_ACTOR, tags)
        self.logger = get_logger(f"actor.{name}")
        # distributed logging (runtime-gated): this actor's records also
        # publish to {topic_path}/log, where the Recorder's namespace
        # filter picks them up
        self._transport_log_handler = None
        if getattr(runtime, "log_transport", False):
            handler = TransportLoggingHandler(lambda: runtime.message,
                                              self.topic_log)
            handler.setFormatter(logging.Formatter(
                "%(levelname)s %(name)s: %(message)s"))
            self.logger.addHandler(handler)
            self._transport_log_handler = handler
        base_share = {
            "lifecycle": "ready",
            "log_level": "INFO",
            "running": True,
        }
        base_share.update(share or {})
        self.ec_producer = ECProducer(self, base_share)
        self.ec_producer.add_handler(self._share_changed)
        self.share = self.ec_producer.share

        self._mailbox_control = f"{self.topic_path}/control#mb"
        self._mailbox_in = f"{self.topic_path}/in#mb"
        # control registered first → drains with priority
        runtime.event.add_mailbox_handler(self._mailbox_handler,
                                          self._mailbox_control)
        runtime.event.add_mailbox_handler(self._mailbox_handler,
                                          self._mailbox_in)
        runtime.add_message_handler(self._topic_in_handler, self.topic_in)

    # -- inbound -----------------------------------------------------------
    def _topic_in_handler(self, _topic, payload) -> None:
        started = time.perf_counter()
        try:
            if wire.is_envelope(payload):
                # binary wire envelope: arrays arrive as read-only
                # views, scalars keep sexpr (string) semantics
                command, params, trace_fields = \
                    wire.decode_envelope(payload, with_trace=True)
            else:
                command, params = parse(payload)
                wire.pop_tenant(params)     # appended after trace
                trace_fields = wire.pop_trace(params)
        except Exception:
            self.logger.warning("%s: unparseable payload %r",
                                self.name, payload)
            return
        context = None
        if trace_fields is not None:
            now = self.runtime.event.clock.now()
            context = tracing.TraceContext.from_fields(trace_fields, now)
            trc = tracing.tracer
            if trc.enabled and context is not None:
                decode_dur = time.perf_counter() - started
                if context.sent is not None:
                    # wire transit (engine-clock seconds), recordable
                    # only when sender and receiver clocks are
                    # comparable; the span ENDS at arrival
                    transit = now - context.sent
                    if 0.0 <= transit <= tracing.CLOCK_COMPARABLE_HORIZON:
                        trc.record("deliver", started - transit, transit,
                                   context=context, cat="wire",
                                   proc=self.name,
                                   span_id=tracing.new_span_id(),
                                   args={"command": command})
                trc.record("decode", started, decode_dur,
                           context=context, cat="wire", proc=self.name,
                           span_id=tracing.new_span_id(),
                           args={"command": command})
        if command:
            self._post_message(command, params, trace=context)

    def _post_message(self, command: str, arguments, trace=None) -> None:
        mailbox = self._mailbox_control if command.startswith("control_") \
            else self._mailbox_in
        self.runtime.event.mailbox_put(
            mailbox, ActorMessage(self, command, arguments, trace=trace))

    def _mailbox_handler(self, _name, message, put_time) -> None:
        trc = tracing.tracer
        if trc.enabled and message.trace is not None:
            # mailbox dwell: engine-clock put → drain (the "queue" hop);
            # the span ends at the drain
            waited = max(0.0, self.runtime.event.clock.now() - put_time)
            now = time.perf_counter()
            trc.record("queue", now - waited, waited,
                       context=message.trace, cat="wire", proc=self.name,
                       span_id=tracing.new_span_id(),
                       args={"command": message.command})
        message.invoke(self.logger)

    # -- local deferred invocation (used by pipelines, tests) --------------
    def post(self, command: str, *arguments) -> None:
        self._post_message(command, list(arguments))

    # -- share change plumbing ---------------------------------------------
    def _share_changed(self, command, name, value) -> None:
        if name == "log_level" and command in ("add", "update"):
            try:
                self.logger.setLevel(str(value))
            except ValueError:
                pass

    # -- built-in control methods ------------------------------------------
    def control_stop(self) -> None:
        self.ec_producer.update("lifecycle", "stopped")
        self.stop()

    def stop(self) -> None:
        if self._transport_log_handler is not None:
            # loggers are global by name — leaked handlers would double-
            # publish for a later same-named actor
            self.logger.removeHandler(self._transport_log_handler)
            self._transport_log_handler = None
        self.runtime.event.remove_mailbox_handler(self._mailbox_control)
        self.runtime.event.remove_mailbox_handler(self._mailbox_in)
        self.runtime.remove_message_handler(self._topic_in_handler,
                                            self.topic_in)
        self.ec_producer.terminate()
        super().stop()


def get_public_methods(protocol_class) -> list[str]:
    """Public callables declared by a protocol class (not inherited from
    object, not underscore-prefixed)."""
    methods = []
    for name, member in inspect.getmembers(protocol_class):
        if name.startswith("_") or not callable(member):
            continue
        if getattr(object, name, None) is member:
            continue
        methods.append(name)
    return methods


class _RemoteProxy:
    def __init__(self, runtime, topic_in):
        self._runtime = runtime
        self._topic_in = topic_in

    def __repr__(self):
        return f"RemoteProxy({self._topic_in})"


def get_remote_proxy(runtime, topic_in: str, protocol_class,
                     codec_hints=None):
    """Build a proxy object: calling proxy.method(a, b) publishes
    "(method a b)" to `topic_in` (fire-and-forget, like the reference).

    When the runtime's transport is binary-capable and an argument holds
    an array, a tensor or bytes, the call ships as a binary wire envelope
    instead of text; a tensor on the card takes one host copy there.
    codec_hints ({dict_key: codec}) opts named arrays into a lossy wire
    codec (see transport/wire.py).  A value the wire cannot carry raises
    wire.WireError to the caller.

    An ambient trace context at call time rides the wire — envelope
    header on binary transports, trailing sexpr marker on text — so the
    receiving actor's dispatch inherits the caller's trace id and
    remaining deadline."""
    proxy = _RemoteProxy(runtime, topic_in)
    for method_name in get_public_methods(protocol_class):
        def remote_call(*args, _name=method_name, **kwargs):
            if kwargs:
                raise TypeError("remote calls are positional-only")
            context = tracing.current_trace()
            trace_fields = None
            if context is not None:
                trace_fields = context.to_fields(
                    runtime.event.clock.now())
            started = time.perf_counter()
            payload = wire.encode_rpc(
                _name, list(args), transport=runtime.message,
                codec_hints=codec_hints, trace=trace_fields)
            trc = tracing.tracer
            if trc.enabled and context is not None:
                trc.record("encode", started,
                           time.perf_counter() - started,
                           context=context, cat="wire",
                           proc=getattr(runtime, "name", ""),
                           span_id=tracing.new_span_id(),
                           args={"command": _name})
            runtime.publish(topic_in, payload)
        setattr(proxy, method_name, remote_call)
    return proxy


class ActorDiscovery:
    """Find actors by ServiceFilter and get live add/remove callbacks."""

    def __init__(self, runtime, services_cache: ServicesCache | None = None):
        self.runtime = runtime
        self.cache = services_cache or ServicesCache(runtime)

    def add_handler(self, handler, service_filter) -> None:
        self.cache.add_handler(handler, service_filter)

    def remove_handler(self, handler) -> None:
        self.cache.remove_handler(handler)

    def share_services(self) -> list:
        return list(self.cache.services)
