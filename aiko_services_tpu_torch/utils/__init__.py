# Host utilities the port keeps its own copies of.

from .sexpr import (                                        # noqa: F401
    ParseError, parse, parse_sexpr, generate, generate_sexpr,
    parse_int, parse_float, parse_number, parse_bool,
    list_to_dict, dict_to_list,
)
from .graph import Graph, Node, GraphError                  # noqa: F401
from .configuration import (                                # noqa: F401
    get_namespace, get_hostname, get_pid, get_username, pid_verified,
    TransportConfig, get_transport_configuration,
)
from .logger import (                                       # noqa: F401
    get_logger, get_log_level_name, TransportLoggingHandler,
)
from .lru_cache import LRUCache                             # noqa: F401
from .importer import load_module, load_class               # noqa: F401
from .lock import Lock                                      # noqa: F401
from .backoff import jittered_backoff                       # noqa: F401
