# Service layer: discoverable, addressable endpoints.
#
# Capability parity with the reference service layer
# (reference: aiko_services/service.py:105-569): versioned protocol URIs,
# the discovery record (topic_path, name, protocol, transport, owner, tags),
# wildcard filters, tag matching, the two-level Services collection, and the
# Service base that registers itself with its process runtime and derives
# its control/in/log/out/state topics.
#
# Design change: services are plain classes wired by constructor injection —
# no interface/implementation weaver (the reference's "Frankenstein"
# composition engine, component.py:50-219, exists to emulate exactly this).
#
# The port's own copy of aiko_services_tpu/service.py.

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "ServiceProtocol", "ServiceFields", "ServiceFilter", "ServiceTags",
    "ServiceTopicPath", "Services", "Service",
    "PROTOCOL_PREFIX", "SERVICE_PROTOCOL_VERSION",
]

# Protocol URIs identify what a service speaks, independent of its name.
PROTOCOL_PREFIX = "aiko_tpu/protocol"
SERVICE_PROTOCOL_VERSION = "0"


class ServiceProtocol:
    def __init__(self, name: str, version: str = SERVICE_PROTOCOL_VERSION,
                 prefix: str = PROTOCOL_PREFIX):
        self.name = name
        self.version = version
        self.prefix = prefix

    def __str__(self):
        return f"{self.prefix}/{self.name}:{self.version}"

    @staticmethod
    def name_of(protocol_uri: str) -> str:
        return protocol_uri.rsplit("/", 1)[-1].split(":")[0]


class ServiceTags:
    """Tags are "key=value" strings on the discovery record."""

    @staticmethod
    def to_dict(tags) -> dict:
        out = {}
        for tag in tags or ():
            if "=" in tag:
                k, v = tag.split("=", 1)
                out[k] = v
        return out

    @staticmethod
    def match(tags, required) -> bool:
        """True when every tag in `required` appears in `tags` ("*" = any)."""
        if required in ("*", None) or not required:
            return True
        have = set(tags or ())
        return all(tag in have for tag in required)


class ServiceTopicPath:
    """{namespace}/{hostname}/{process_id}/{service_id}"""

    def __init__(self, namespace, hostname, process_id, service_id):
        self.namespace = namespace
        self.hostname = hostname
        self.process_id = str(process_id)
        self.service_id = str(service_id)

    @classmethod
    def parse(cls, topic_path: str):
        parts = topic_path.split("/")
        if len(parts) == 4:
            return cls(*parts)
        if len(parts) == 3:
            return cls(parts[0], parts[1], parts[2], "0")
        return None

    @property
    def process_path(self) -> str:
        return f"{self.namespace}/{self.hostname}/{self.process_id}"

    def terse(self) -> str:
        return f"{self.hostname}:{self.process_id}.{self.service_id}"

    def __str__(self):
        return f"{self.process_path}/{self.service_id}"


@dataclass
class ServiceFields:
    """The discovery record the registrar stores per service."""
    topic_path: str
    name: str
    protocol: str
    transport: str = "memory"
    owner: str = ""
    tags: list = field(default_factory=list)

    def to_record(self) -> list:
        return [self.topic_path, self.name, self.protocol,
                self.transport, self.owner, list(self.tags)]

    @classmethod
    def from_record(cls, record):
        topic_path, name, protocol, transport, owner = record[:5]
        tags = record[5] if len(record) > 5 else []
        if isinstance(tags, str):
            tags = [tags]
        return cls(topic_path, name, protocol, transport, owner, list(tags))


@dataclass
class ServiceFilter:
    """Wildcard filter over discovery records ("*" matches anything)."""
    topic_paths: object = "*"     # "*" or list of topic paths
    name: str = "*"
    protocol: str = "*"
    transport: str = "*"
    owner: str = "*"
    tags: object = "*"            # "*" or list of required "k=v" tags

    def matches(self, fields: ServiceFields) -> bool:
        if self.topic_paths != "*" and \
                fields.topic_path not in self.topic_paths:
            return False
        if self.name != "*" and fields.name != self.name:
            return False
        if self.protocol != "*":
            if self.protocol.endswith("*"):
                if not fields.protocol.startswith(self.protocol[:-1]):
                    return False
            elif fields.protocol != self.protocol:
                return False
        if self.transport != "*" and fields.transport != self.transport:
            return False
        if self.owner != "*" and fields.owner != self.owner:
            return False
        return ServiceTags.match(fields.tags, self.tags)


class Services:
    """Two-level map: process topic path → service topic path → fields."""

    def __init__(self):
        self._processes: dict[str, dict[str, ServiceFields]] = {}

    def add(self, fields: ServiceFields) -> None:
        tp = ServiceTopicPath.parse(fields.topic_path)
        if tp is None:
            return
        self._processes.setdefault(tp.process_path, {})[
            fields.topic_path] = fields

    def remove(self, topic_path: str) -> ServiceFields | None:
        tp = ServiceTopicPath.parse(topic_path)
        if tp is None:
            return None
        process = self._processes.get(tp.process_path)
        if not process:
            return None
        fields = process.pop(topic_path, None)
        if not process:
            self._processes.pop(tp.process_path, None)
        return fields

    def remove_process(self, process_path: str) -> list[ServiceFields]:
        process = self._processes.pop(process_path, None)
        return list(process.values()) if process else []

    def get(self, topic_path: str) -> ServiceFields | None:
        tp = ServiceTopicPath.parse(topic_path)
        if tp is None:
            return None
        return self._processes.get(tp.process_path, {}).get(topic_path)

    def filter(self, service_filter: ServiceFilter) -> list[ServiceFields]:
        return [f for f in self if service_filter.matches(f)]

    def __iter__(self):
        for process in list(self._processes.values()):
            yield from list(process.values())

    def __len__(self):
        return sum(len(p) for p in self._processes.values())

    def count_processes(self) -> int:
        return len(self._processes)


class Service:
    """A discoverable endpoint.  Subclasses implement behaviour; the
    constructor registers with the process runtime, which assigns the
    service_id and wires topic routing."""

    def __init__(self, runtime, name: str,
                 protocol: ServiceProtocol | str | None = None,
                 tags=None, owner: str | None = None):
        self.runtime = runtime
        self.name = name
        self.protocol = str(protocol) if protocol else \
            str(ServiceProtocol("service"))
        self.tags = list(tags or [])
        self.owner = owner if owner is not None else runtime.username
        self.service_id = runtime.add_service(self)
        self.topic_path = f"{runtime.topic_path}/{self.service_id}"

    # per-service topics (reference: service.py:539-543)
    @property
    def topic_control(self):
        return f"{self.topic_path}/control"

    @property
    def topic_in(self):
        return f"{self.topic_path}/in"

    @property
    def topic_log(self):
        return f"{self.topic_path}/log"

    @property
    def topic_out(self):
        return f"{self.topic_path}/out"

    @property
    def topic_state(self):
        return f"{self.topic_path}/state"

    def service_fields(self) -> ServiceFields:
        return ServiceFields(
            topic_path=self.topic_path, name=self.name,
            protocol=self.protocol, transport=self.runtime.transport_name,
            owner=self.owner, tags=self.tags)

    def add_tags(self, tags) -> None:
        for tag in tags:
            if tag not in self.tags:
                self.tags.append(tag)

    def stop(self) -> None:
        """Deregister from the runtime."""
        self.runtime.remove_service(self.service_id)
