"""Redis-backed storage hook — the analog of the reference's go-redis hook
(hooks/storage/redis/redis.go); a copy of the JAX package's. Gated on the optional ``redis`` package; the
hook raises a clear error at init when the client library is absent (this
image does not ship it)."""

from __future__ import annotations

from typing import Any, Iterable, Optional

from .base import StorageHook

DEFAULT_HPREFIX = "mqtt-tpu-"  # reference uses "mochi-" (redis.go:25)


class RedisOptions:
    def __init__(
        self,
        address: str = "localhost:6379",
        username: str = "",
        password: str = "",
        database: int = 0,
        h_prefix: str = DEFAULT_HPREFIX,
        client: Any = None,
    ) -> None:
        self.address = address
        self.username = username
        self.password = password
        self.database = database
        self.h_prefix = h_prefix
        # injectable client implementing set/get/delete/scan_iter/ping/close
        # — the test seam, mirroring the reference's miniredis-backed suite
        # (hooks/storage/redis/redis_test.go:19,116)
        self.client = client


class RedisStore(StorageHook):
    """Mirrors broker state into redis string keys under a prefix."""

    def __init__(self) -> None:
        super().__init__()
        self.config = RedisOptions()
        self._client = None

    def id(self) -> str:
        return "redis-db"

    def init(self, config: Any) -> None:
        if config is not None and not isinstance(config, RedisOptions):
            raise TypeError("invalid config type provided")
        self.config = config or RedisOptions()
        if self.config.client is not None:
            self._client = self.config.client
            self._client.ping()
            return
        try:
            import redis  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "the redis storage hook requires the 'redis' package, which is "
                "not installed in this environment"
            ) from e
        host, _, port = self.config.address.rpartition(":")
        self._client = redis.Redis(
            host=host or "localhost",
            port=int(port or 6379),
            username=self.config.username or None,
            password=self.config.password or None,
            db=self.config.database,
        )
        self._client.ping()

    def stop(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def _key(self, key: str) -> str:
        return self.config.h_prefix + key

    def _set(self, key: str, value: bytes) -> None:
        self._client.set(self._key(key), value)

    def _get(self, key: str) -> Optional[bytes]:
        return self._client.get(self._key(key))

    def _del(self, key: str) -> None:
        self._client.delete(self._key(key))

    def _iter(self, prefix: str) -> Iterable[bytes]:
        out = []
        for k in self._client.scan_iter(match=self._key(prefix) + "*"):
            v = self._client.get(k)
            if v is not None:
                out.append(v)
        return out
