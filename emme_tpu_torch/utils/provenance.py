"""Run provenance: git hash + timestamps recorded into output.json
(reference main.cpp:215-221, build_info.sh, functions.cpp:8-20).
Counterpart of ``emme_tpu/utils/provenance.py``."""

from __future__ import annotations

import pathlib
import subprocess
import time

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent


def git_commit_hash() -> str | None:
    """Hash of the framework checkout (not the user's cwd); None where the
    package does not sit in a git checkout."""
    try:
        out = subprocess.run(
            ["git", "-C", str(_PKG_DIR), "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5, check=True)
        return out.stdout.strip()
    except Exception:
        return None


def _iso(t=None) -> str:
    """ISO-8601 local time with a colon in the TZ offset, the reference's
    get_date_string layout (functions.cpp:8-20)."""
    s = time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime(t))
    if len(s) >= 5 and s[-5] in "+-":
        s = s[:-2] + ":" + s[-2:]
    return s


def date_string() -> str:
    """Now, in the reference's get_date_string layout."""
    return _iso()


def build_time() -> str:
    """Install/mtime of the package's newest Python file, the analogue of
    the reference's compile-time EMME_BUILD_DATE macro
    (build_info.sh:1-7)."""
    return _iso(max((f.stat().st_mtime for f in _PKG_DIR.rglob("*.py")),
                    default=None))
