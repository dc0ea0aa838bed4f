"""Utilities: profiling/tracing hooks and structured logging.

The reference has no in-library observability (SURVEY.md §5: wall-clock +
memory_profiler in the benchmark harness only); these are the in-library
equivalents, plus the persistent compile-cache helper."""
from .cache import enable_compile_cache
from .profiling import op_timer, trace
from .log import get_logger
