"""Standalone external KV store speaking wire v1.

The deployment-side half of controller HA (reference:
redis_store_client.cc's Redis, SURVEY N7): a tiny durable KV service the
controller can point its snapshot store at
(RAY_TPU_controller_store=kv://host:port). Keys persist to an
append-compact JSON file, so the service itself survives restarts.

    python -m ray_tpu_torch._private.kv_store_server --port 6399 \
        --data /var/lib/raytpu-kv.json
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import sys

from ray_tpu_torch._private import atomic_io
from ray_tpu_torch._private.rpc import RpcServer


class KVStoreServer:
    def __init__(self, data_path: str | None = None):
        self.data_path = data_path
        self.kv: dict[str, dict[str, bytes]] = {}
        self._load()

    def _load(self) -> None:
        if not self.data_path or not os.path.exists(self.data_path):
            return
        try:
            with open(self.data_path) as fh:
                raw = json.load(fh)
            self.kv = {
                ns: {
                    key: base64.b64decode(value)
                    for key, value in entries.items()
                }
                for ns, entries in raw.items()
            }
        except Exception as exc:
            print(f"[raytpu-kv] load failed: {exc}", file=sys.stderr)

    def _flush(self) -> None:
        if not self.data_path:
            return
        raw = {
            ns: {
                key: base64.b64encode(value).decode()
                for key, value in entries.items()
            }
            for ns, entries in self.kv.items()
        }
        atomic_io.atomic_write_json(self.data_path, raw)

    async def rpc_kv_put(self, conn, payload) -> dict:
        ns = payload.get("namespace", "default")
        key = payload["key"]
        entries = self.kv.setdefault(ns, {})
        if key in entries and not payload.get("overwrite", True):
            return {"status": "exists"}
        entries[key] = payload["value"]
        self._flush()
        return {"status": "ok"}

    async def rpc_kv_get(self, conn, payload) -> dict:
        ns = payload.get("namespace", "default")
        value = self.kv.get(ns, {}).get(payload["key"])
        if value is None:
            return {"status": "missing"}
        return {"status": "ok", "value": value}

    async def rpc_kv_del(self, conn, payload) -> dict:
        ns = payload.get("namespace", "default")
        existed = self.kv.get(ns, {}).pop(payload["key"], None) is not None
        self._flush()
        return {"status": "ok", "deleted": existed}

    async def rpc_kv_keys(self, conn, payload) -> dict:
        ns = payload.get("namespace", "default")
        return {"status": "ok", "keys": sorted(self.kv.get(ns, {}))}

    async def rpc_ping(self, conn, payload) -> dict:
        return {"status": "ok", "role": "raytpu-kv-store"}


async def run(host: str, port: int, data_path: str | None,
              ready_file: str | None = None) -> None:
    store = KVStoreServer(data_path)
    server = RpcServer(name="kv-store")
    server.route_object(store)
    bound = await server.start(host, port)
    print(f"[raytpu-kv] listening on {host}:{bound}", flush=True)
    if ready_file:
        # Atomic: the parent polls for this file to learn the bound port.
        atomic_io.atomic_write_json(
            ready_file, {"host": host, "port": bound}
        )
    while True:
        await asyncio.sleep(3600)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--data", default=None)
    parser.add_argument("--ready-file", default=None)
    args = parser.parse_args()
    asyncio.run(run(args.host, args.port, args.data, args.ready_file))


if __name__ == "__main__":
    main()
