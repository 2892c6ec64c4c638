"""File discovery: glob-pattern directory polling.

Reference: core/file_server/polling/PollingDirFile.cpp (the discovery
round); the port's copy of the JAX package's ``input/file/polling.py``
without ``PollingModify``, which no caller uses (the file server asks its
readers for new bytes).  The file server merges it with inotify
(``event_listener.py``) where the kernel offers it; polling alone is the
contract where it does not.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import List, Set


@dataclass
class FileDiscoveryConfig:
    """Reference FileDiscoveryOptions: FilePaths (glob), MaxDirSearchDepth,
    ExcludeFilePaths/ExcludeFiles/ExcludeDirs."""

    file_paths: List[str]
    exclude_file_paths: List[str] = None
    exclude_files: List[str] = None
    exclude_dirs: List[str] = None

    def __post_init__(self):
        self.exclude_file_paths = self.exclude_file_paths or []
        self.exclude_files = self.exclude_files or []
        self.exclude_dirs = self.exclude_dirs or []


class PollingDirFile:
    def __init__(self, config: FileDiscoveryConfig):
        self.config = config

    def poll(self) -> List[str]:
        """One discovery round: resolve glob patterns → matching file paths."""
        found: List[str] = []
        seen: Set[str] = set()
        for pattern in self.config.file_paths:
            for path in glob.glob(pattern, recursive="**" in pattern):
                if path in seen or not os.path.isfile(path):
                    continue
                if self._excluded(path):
                    continue
                seen.add(path)
                found.append(path)
        return found

    def _excluded(self, path: str) -> bool:
        import fnmatch
        base = os.path.basename(path)
        d = os.path.dirname(path)
        for pat in self.config.exclude_file_paths:
            if fnmatch.fnmatch(path, pat):
                return True
        for pat in self.config.exclude_files:
            if fnmatch.fnmatch(base, pat):
                return True
        for pat in self.config.exclude_dirs:
            if fnmatch.fnmatch(d, pat):
                return True
        return False
