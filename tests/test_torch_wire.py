"""The port's wire against the reference's, byte for byte, with no cluster.

* For seeded payloads of every message of the schema, the port's generated
  encoders give the reference's bytes, and each package decodes the other's.
* ``rpc._pack`` frames (the envelope of every RPC) are equal.
* ``serialization`` gives the reference's bytes for numpy arrays, bytes and
  nested containers holding ``ObjectRef`` placeholders (persistent id
  ``("raytpu_ref", id, owner)``), and each package reads the other's.
* The port's generator, run with ``--check``, finds its own output fresh.
"""

import importlib.util
import io
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ray_tpu._private import object_ref as ref_object_ref
from ray_tpu._private import rpc as ref_rpc
from ray_tpu._private import serialization as ref_serial
from ray_tpu._private import wire_gen as ref_wire
from ray_tpu_torch._private import object_ref as port_object_ref
from ray_tpu_torch._private import rpc as port_rpc
from ray_tpu_torch._private import serialization as port_serial
from ray_tpu_torch._private import wire_gen as port_wire

ROOT = Path(__file__).resolve().parent.parent
SCHEMA_DIR = ROOT / "ray_tpu_torch" / "_native" / "schema"


def _load(name: str, path: Path):
    # By path, under a name of its own: the reference's schema module has
    # the same file name.
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


wire_schema = _load("port_wire_schema", SCHEMA_DIR / "wire_schema.py")


def _snake(name: str) -> str:
    return "".join(("_" + c.lower()) if c.isupper() and i and not name[i - 1].isupper()
                   else c.lower() for i, c in enumerate(name))


def _value(ftype: str, rng: np.random.Generator, depth: int = 0):
    if ftype == "str":
        return "".join(rng.choice(list("abcxyz-_09é"), size=int(rng.integers(0, 12))))
    if ftype == "bytes":
        return rng.bytes(int(rng.integers(0, 40)))
    if ftype == "bool":
        return bool(rng.integers(0, 2))
    if ftype == "i64":
        return int(rng.integers(-2**40, 2**40))
    if ftype == "f64":
        return float(rng.standard_normal())
    if ftype == "u32fixed":
        return int(rng.integers(0, 2**32))
    if ftype == "map_f64":
        return {f"r{i}": float(rng.integers(0, 9)) / 2 for i in range(int(rng.integers(0, 4)))}
    if ftype == "raw":
        return [None, {"k": [1, 2.5, "v"]}, ["127.0.0.1", int(rng.integers(1, 65535))]][
            int(rng.integers(0, 3))]
    kind, name = ftype.split(":", 1)
    if kind == "msg":
        return _message(name, rng, depth + 1)
    return [_message(name, rng, depth + 1) for _ in range(int(rng.integers(0, 3)))]


def _message(name: str, rng: np.random.Generator, depth: int = 0) -> dict:
    fields = wire_schema.MESSAGES[name]
    # Every field, or a seeded subset of them (decoders default the rest),
    # plus a key the schema does not know (encoders pass it through).
    keep = fields if rng.integers(0, 2) or depth else [f for f in fields if rng.integers(0, 2)]
    out = {fname: _value(ftype, rng, depth) for fname, ftype, _ in keep}
    if rng.integers(0, 2):
        out["future_field"] = {"x": [1, 2]}
    return out


def test_the_schema_is_the_references():
    ref_schema = _load("ref_wire_schema", ROOT / "src" / "schema" / "wire_schema.py")
    assert ref_schema.MESSAGES == wire_schema.MESSAGES
    assert ref_schema.METHOD_SCHEMAS == wire_schema.METHOD_SCHEMAS
    assert {_snake(n) for n in wire_schema.MESSAGES} == {
        name[len("encode_"):] for name in dir(port_wire) if name.startswith("encode_")}


@pytest.mark.parametrize("name", sorted(wire_schema.MESSAGES))
def test_every_message_encodes_to_the_references_bytes(name):
    rng = np.random.default_rng(sorted(wire_schema.MESSAGES).index(name))
    enc, dec = f"encode_{_snake(name)}", f"decode_{_snake(name)}"
    for _ in range(25):
        payload = _message(name, rng)
        port_raw = getattr(port_wire, enc)(payload)
        ref_raw = getattr(ref_wire, enc)(payload)
        assert port_raw == ref_raw
        assert getattr(port_wire, dec)(ref_raw) == getattr(ref_wire, dec)(port_raw)


def test_splice_parts_and_patched_seq_are_the_references():
    rng = np.random.default_rng(7)
    for name, make in (("TaskSpec", "make_task_spec_parts"),
                       ("ActorTaskSpec", "make_actor_task_spec_parts")):
        template = dict(_message(name, rng, depth=1), task_id="", args=b"")
        parts = getattr(port_wire, make)(template)
        assert parts == getattr(ref_wire, make)(template)
        spliced = port_wire.splice(parts, "tsk-1", b"ARGS", seq=99)
        assert spliced == ref_wire.splice(parts, "tsk-1", b"ARGS", seq=99)
    raw = ref_wire.encode_actor_task_spec(_message("ActorTaskSpec", rng, depth=1))
    assert port_wire.patch_seq(raw, 123456) == ref_wire.patch_seq(raw, 123456)
    assert set(port_wire.METHOD_CODECS) == set(ref_wire.METHOD_CODECS)


@pytest.mark.parametrize("kind", [port_rpc.REQ, port_rpc.REP, port_rpc.ERR, port_rpc.PUSH])
def test_rpc_frames_are_the_references(kind):
    rng = np.random.default_rng(kind)
    for method, payload in (("push_task", {"a": 1, "b": [b"x", None, 2.5]}),
                            ("", None), ("lease_worker", _message("WorkerLeaseRequest", rng))):
        msgid = int(rng.integers(0, 2**32))
        assert port_rpc._pack(kind, msgid, method, payload) == ref_rpc._pack(
            kind, msgid, method, payload)
    assert (port_rpc.REQ, port_rpc.REP, port_rpc.ERR, port_rpc.PUSH) == (
        ref_rpc.REQ, ref_rpc.REP, ref_rpc.ERR, ref_rpc.PUSH)
    assert port_rpc.WIRE_VERSION == ref_rpc.WIRE_VERSION


def _values(object_ref_module):
    rng = np.random.default_rng(3)
    ref = object_ref_module.ObjectRef("obj-0123abcd", ("127.0.0.1", 4321))
    return [
        None, 7, "text", b"\x00bytes" * 10, [1, (2, 3), {"k": "v"}],
        np.arange(12, dtype=np.float32).reshape(3, 4),
        rng.standard_normal(50_000).astype(np.float64),
        {"weights": rng.integers(0, 255, 4096, dtype=np.uint8), "ref": ref,
         "nested": [ref, {"again": ref}], "blob": b"b" * 200},
    ]


@pytest.mark.parametrize("index", range(8))
def test_serialization_bytes_are_the_references(index):
    port_value = _values(port_object_ref)[index]
    ref_value = _values(ref_object_ref)[index]
    port_parts, port_total, port_refs = port_serial.serialize_parts(port_value)
    ref_parts, ref_total, ref_refs = ref_serial.serialize_parts(ref_value)
    port_raw, ref_raw = port_serial.join_parts(port_parts), ref_serial.join_parts(ref_parts)
    assert (port_total, len(port_refs)) == (ref_total, len(ref_refs))
    # Every byte, the out-of-band buffers and the placeholders included.
    assert port_raw == ref_raw

    def resolver(package):
        return lambda object_id, owner: (package, object_id, tuple(owner))

    _assert_same(port_serial.deserialize(ref_raw, resolver("port")),
                 ref_serial.deserialize(port_raw, resolver("ref")))


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _assert_same(a[key], b[key])
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], str) and a[0] in ("port", "ref"):
        # A resolved ref: the same id and owner on either side.
        assert a[1:] == b[1:]
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_a_ref_placeholder_keeps_the_references_tag():
    ref = port_object_ref.ObjectRef("obj-1", ("h", 1))
    payload, refs = port_serial.serialize({"r": ref})
    assert refs == [ref]
    seen = []

    class Spy(pickle.Unpickler):
        def persistent_load(self, pid):
            seen.append(pid)

    meta_len = int.from_bytes(payload[4:12], "little")
    Spy(io.BytesIO(payload[12:12 + meta_len])).load()
    assert seen == [("raytpu_ref", "obj-1", ("h", 1))]


def test_the_generator_check_passes_on_the_ports_copy():
    out = subprocess.run([sys.executable, str(SCHEMA_DIR / "gen_wire.py"), "--check"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # The generated module is the reference's but for the line naming its
    # generator.
    port = (ROOT / "ray_tpu_torch" / "_private" / "wire_gen.py").read_text().splitlines()
    ref = (ROOT / "ray_tpu" / "_private" / "wire_gen.py").read_text().splitlines()
    assert len(port) == len(ref)
    assert [i for i, (a, b) in enumerate(zip(port, ref)) if a != b] == [0]
