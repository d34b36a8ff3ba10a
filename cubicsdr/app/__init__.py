"""Application shell: persisted config, sessions, bookmarks, CLI.

JSON replaces the reference's DataTree/tinyxml persistence stack
(ref: src/util/DataTree.* 1.7k LoC of typed-XML plumbing) — the *schema*
(what gets saved) is kept 1:1, the serialization is plain JSON.
"""

from cubicsdr.app.config import AppConfig, DeviceConfig  # noqa: F401
from cubicsdr.app.session import SessionMgr  # noqa: F401
from cubicsdr.app.bookmarks import BookmarkMgr, BookmarkEntry  # noqa: F401
