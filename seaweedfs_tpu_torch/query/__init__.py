"""Query engine: S3-Select-style SQL over JSON/CSV objects.

Reference: weed/query/json/query_json.go (JSON projection/filter),
server/volume_grpc_query.go (the volume server's streaming Query RPC),
pb/volume_server.proto:92.
"""

from .engine import run_query  # noqa: F401
from .sql import SelectStatement, parse_select  # noqa: F401
