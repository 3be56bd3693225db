"""Temp file management.

Equivalent of the reference's Temp_File_Manager singleton
(include/sbwt/TempFileManager.hh:22-126): unique filenames under a
settable directory, created exclusively, tracked, and removed at cleanup
or interpreter exit."""
from __future__ import annotations

import atexit
import os
import secrets
import threading


class TempFileManager:
    def __init__(self):
        self._dir = "."
        self._files: set[str] = set()
        self._mu = threading.Lock()
        atexit.register(self.delete_all_files)

    def set_dir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._dir = path

    def get_dir(self) -> str:
        return self._dir

    def create_filename(self, prefix: str = "", suffix: str = "") -> str:
        """Unique filename, created with O_CREAT|O_EXCL like the reference
        (TempFileManager.hh:85-107)."""
        with self._mu:
            while True:
                name = os.path.join(
                    self._dir, f"{prefix}{secrets.token_hex(8)}{suffix}"
                )
                try:
                    fd = os.open(name, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
                except FileExistsError:
                    continue
                os.close(fd)
                self._files.add(name)
                return name

    def delete_file(self, name: str) -> None:
        with self._mu:
            self._files.discard(name)
            try:
                os.remove(name)
            except OSError:
                pass

    def delete_all_files(self) -> None:
        with self._mu:
            for name in list(self._files):
                try:
                    os.remove(name)
                except OSError:
                    pass
            self._files.clear()


# module-level singleton (globals.cpp:34-37)
manager = TempFileManager()


def get_temp_file_manager() -> TempFileManager:
    return manager
