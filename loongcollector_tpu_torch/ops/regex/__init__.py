from .charclass import CharClass  # noqa: F401
from .program import (PatternTier, SegmentProgram,  # noqa: F401
                      Tier1Unsupported, compile_tier1)
