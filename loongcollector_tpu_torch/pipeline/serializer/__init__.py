from .batch_json import dumps_row, native_group_rows, ndjson_payload  # noqa: F401
from .json_serializer import JsonSerializer  # noqa: F401
