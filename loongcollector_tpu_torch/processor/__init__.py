"""Processor plugins of the port.

Names keep the reference's ``_native`` suffix and its ``_tpu`` aliases, so
one pipeline YAML drives either package.
"""


def register_all(registry) -> None:
    from .classify_url import ProcessorClassifyUrl
    from .field_ops import (ProcessorAddFields, ProcessorDrop,
                            ProcessorRenameFields, ProcessorStrReplace)
    from .filter import ProcessorFilter
    from .grok import ProcessorGrok
    from .parse_delimiter import ProcessorParseDelimiter
    from .parse_json import ProcessorParseJson
    from .parse_regex import ProcessorParseRegex
    from .parse_timestamp import ProcessorParseTimestamp
    from .split_log_string import ProcessorSplitLogString
    from .split_multiline import ProcessorSplitMultilineLogString
    registry.register_processor("processor_split_log_string_native",
                                ProcessorSplitLogString)
    registry.register_processor("processor_split_multiline_log_string_native",
                                ProcessorSplitMultilineLogString)
    registry.register_processor("processor_parse_regex_native",
                                ProcessorParseRegex)
    registry.register_processor("processor_parse_regex_tpu",
                                ProcessorParseRegex)
    registry.register_processor("processor_parse_json_native",
                                ProcessorParseJson)
    registry.register_processor("processor_parse_json_tpu",
                                ProcessorParseJson)
    registry.register_processor("processor_parse_delimiter_native",
                                ProcessorParseDelimiter)
    registry.register_processor("processor_parse_delimiter_tpu",
                                ProcessorParseDelimiter)
    registry.register_processor("processor_parse_timestamp_native",
                                ProcessorParseTimestamp)
    registry.register_processor("processor_filter_native", ProcessorFilter)
    registry.register_processor("processor_grok", ProcessorGrok)
    registry.register_processor("processor_classify_url_tpu",
                                ProcessorClassifyUrl)
    registry.register_processor("processor_classify_url_native",
                                ProcessorClassifyUrl)
    registry.register_processor("processor_add_fields", ProcessorAddFields)
    registry.register_processor("processor_rename", ProcessorRenameFields)
    registry.register_processor("processor_drop", ProcessorDrop)
    registry.register_processor("processor_strreplace", ProcessorStrReplace)
