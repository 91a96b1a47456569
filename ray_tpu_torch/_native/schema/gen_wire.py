#!/usr/bin/env python3
"""Wire-schema compiler: wire_schema.py -> Python codecs.

The port's copy of ray_tpu's ``src/schema/gen_wire.py``. One schema source
(wire_schema.py, the protobuf-definition role of src/ray/protobuf/*.proto
per SURVEY N14) emits the port's encoders/decoders:

    python ray_tpu_torch/_native/schema/gen_wire.py           # (re)write
    python ray_tpu_torch/_native/schema/gen_wire.py --check   # exit 1 if stale

Output (checked in; a test runs --check):
    ray_tpu_torch/_private/wire_gen.py

The reference also emits the C++ client's header
(``cpp/include/raytpu/wire_gen.h``); the C++ client is ROADMAP item 14f.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)

from wire_schema import MESSAGES, METHOD_SCHEMAS  # noqa: E402

PY_OUT = os.path.join(PACKAGE, "_private", "wire_gen.py")

# Messages that get precompiled splice-part builders (hot-path submit):
# message -> (first variable field, second variable field). Both must be
# str/bytes-typed; everything else is static per template.
SPLICE = {
    "TaskSpec": ("task_id", "args"),
    "ActorTaskSpec": ("task_id", "args"),
}


def snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i and (not name[i - 1].isupper()):
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def validate() -> None:
    for name, fields in MESSAGES.items():
        seen = set()
        for i, (fname, ftype, _default) in enumerate(fields):
            if fname in seen:
                raise SystemExit(f"{name}.{fname}: duplicate field")
            seen.add(fname)
            if ftype == "u32fixed" and i != 0:
                raise SystemExit(f"{name}.{fname}: u32fixed must be first")
            if ftype.startswith(("msg:", "list_msg:")):
                ref = ftype.split(":", 1)[1]
                if ref not in MESSAGES:
                    raise SystemExit(f"{name}.{fname}: unknown message {ref}")
    for method, (req, rep) in METHOD_SCHEMAS.items():
        for ref in (req, rep):
            if ref is not None and ref not in MESSAGES:
                raise SystemExit(f"method {method}: unknown message {ref}")


def topo_order() -> list[str]:
    order: list[str] = []
    seen: set[str] = set()

    def visit(name: str) -> None:
        if name in seen:
            return
        seen.add(name)
        for _f, ftype, _d in MESSAGES[name]:
            if ftype.startswith(("msg:", "list_msg:")):
                visit(ftype.split(":", 1)[1])
        order.append(name)

    for name in MESSAGES:
        visit(name)
    return order


# ---------------------------------------------------------------------------
# Python emission
# ---------------------------------------------------------------------------
def py_default_literal(ftype: str, default) -> str:
    if ftype in ("raw", "msg:Owner") or ftype.startswith("msg:"):
        return repr(default)
    return repr(default)


def gen_python() -> str:
    lines = [
        '"""GENERATED by ray_tpu_torch/_native/schema/gen_wire.py from wire_schema.py',
        "— do not edit by hand; rerun the generator (a test runs --check).",
        "",
        "Typed payload codecs for the task/actor/object/lease RPC methods",
        "(reference protobuf-message role, SURVEY N14). Payloads stay plain",
        "msgpack maps: decoders ignore unknown keys and default missing ones,",
        "encoders pass unknown keys through — version skew is safe both ways.",
        '"""',
        "",
        "from __future__ import annotations",
        "",
        "import struct",
        "",
        "import msgpack",
        "",
        "",
        "def _packb(obj):",
        "    return msgpack.packb(obj, use_bin_type=True)",
        "",
        "",
        "def _unpackb(raw):",
        "    return msgpack.unpackb(raw, raw=False, strict_map_key=False)",
        "",
    ]
    for name in MESSAGES:
        fields = MESSAGES[name]
        fn = snake(name)
        keys = ", ".join(repr(f[0]) for f in fields)
        lines.append("")
        lines.append(f"{fn.upper()}_KEYS = frozenset(({keys},))")
        has_seq = fields[0][1] == "u32fixed"
        # ---- encoder ----
        lines.append("")
        lines.append("")
        lines.append(f"def encode_{fn}(d: dict) -> bytes:")
        lines.append(f'    """{name} -> canonical msgpack bytes."""')
        lines.append("    out = {")
        for fname, ftype, default in fields:
            if ftype == "u32fixed":
                # placeholder forces the 5-byte uint32 form; patched below
                lines.append(f"        {fname!r}: 0xFFFFFFFF,")
            else:
                lines.append(
                    f"        {fname!r}: d.get({fname!r}, {default!r}),"
                )
        lines.append("    }")
        lines.append("    for k, v in d.items():")
        lines.append(f"        if k not in {fn.upper()}_KEYS:")
        lines.append("            out[k] = v  # forward-compat passthrough")
        if has_seq:
            lines.append("    raw = bytearray(_packb(out))")
            lines.append(
                f"    struct.pack_into('>I', raw, _seq_offset(raw), "
                f"int(d.get({fields[0][0]!r}, {fields[0][2]!r})) & 0xFFFFFFFF)"
            )
            lines.append("    return bytes(raw)")
        else:
            lines.append("    return _packb(out)")
        # ---- decoder ----
        lines.append("")
        lines.append("")
        lines.append(f"def decode_{fn}(raw: bytes) -> dict:")
        lines.append(
            f'    """msgpack bytes -> {name} dict (missing keys defaulted,'
        )
        lines.append('    unknown keys preserved)."""')
        lines.append("    d = _unpackb(raw)")
        for fname, _ftype, default in fields:
            lines.append(f"    if {fname!r} not in d:")
            lines.append(f"        d[{fname!r}] = {default!r}")
        lines.append("    return d")
    # Splice-part builders: the per-submit hot path re-encodes only the
    # variable fields (task_id, args); everything static is precompiled
    # from the template once. encode == p0 + packb(task_id) + p1 +
    # packb(args) + p2 (with the u32fixed seq patched at seq_off).
    for name, (var1, var2) in SPLICE.items():
        fields = MESSAGES[name]
        fn = snake(name)
        field_names = [f[0] for f in fields]
        i1, i2 = field_names.index(var1), field_names.index(var2)
        assert i1 < i2, (name, var1, var2)
        lines += [
            "",
            "",
            f"def make_{fn}_parts(d: dict) -> tuple:",
            f'    """Precompile {name} splice parts from a template:',
            f"    encode_{fn}(d | {{{var1}, {var2}}}) ==",
            f"    p0 + packb({var1}) + p1 + packb({var2}) + p2, with the",
            '    u32fixed seq (if any) patched at seq_off. Unknown template',
            '    keys land in p2 (encoder passthrough order)."""',
            f"    unknown = [(k, v) for k, v in d.items()"
            f" if k not in {fn.upper()}_KEYS]",
            f"    p = [_map_header({len(fields)} + len(unknown))]",
            "    seq_off = -1",
        ]
        for idx, (fname, ftype, default) in enumerate(fields):
            if idx == i1:
                lines.append(f"    p.append(_packb({fname!r}))")
                lines.append("    p0 = b''.join(p)")
                lines.append("    p = []")
                continue
            if idx == i2:
                lines.append(f"    p.append(_packb({fname!r}))")
                lines.append("    p1 = b''.join(p)")
                lines.append("    p = []")
                continue
            if ftype == "u32fixed":
                lines.append(f"    p.append(_packb({fname!r}))")
                lines.append("    seq_off = sum(len(x) for x in p) + 1")
                lines.append("    p.append(b'\\xce\\x00\\x00\\x00\\x00')")
                continue
            lines.append(
                f"    p.append(_packb({fname!r}) "
                f"+ _packb(d.get({fname!r}, {default!r})))"
            )
        lines += [
            "    for k, v in unknown:",
            "        p.append(_packb(k) + _packb(v))",
            "    p2 = b''.join(p)",
            "    return p0, p1, p2, seq_off",
        ]
    lines += [
        "",
        "",
        "def _map_header(n: int) -> bytes:",
        "    if n < 16:",
        "        return bytes([0x80 | n])",
        "    if n < 65536:",
        "        return bytes([0xDE, n >> 8, n & 0xFF])",
        "    raise ValueError('map too large')",
        "",
        "",
        "def splice(parts: tuple, var1, var2, seq: int = 0) -> bytes:",
        '    """Pure-Python splice twin of the native submit path (and the',
        '    fallback when the _fastlane extension is unavailable)."""',
        "    p0, p1, p2, seq_off = parts",
        "    out = p0 + _packb(var1) + p1 + _packb(var2) + p2",
        "    if seq_off >= 0:",
        "        buf = bytearray(out)",
        "        struct.pack_into('>I', buf, seq_off, seq & 0xFFFFFFFF)",
        "        out = bytes(buf)",
        "    return out",
        "",
        "",
        "def _seq_offset(raw) -> int:",
        '    """Offset of the 4 seq bytes in a u32fixed-first message."""',
        "    b0 = raw[0]",
        "    if 0x80 <= b0 <= 0x8F:",
        "        header = 1",
        "    elif b0 == 0xDE:",
        "        header = 3",
        "    elif b0 == 0xDF:",
        "        header = 5",
        "    else:",
        "        raise ValueError('not a msgpack map')",
        "    if bytes(raw[header:header + 5]) != b'\\xa3seq\\xce':",
        "        raise ValueError('seq field not first / not u32fixed')",
        "    return header + 5",
        "",
        "",
        "def patch_seq(raw: bytes, seq: int) -> bytes:",
        '    """Rewrite the seq of an encoded u32fixed-first message in',
        '    place — no re-encode (the native submitter uses the same',
        '    offsets)."""',
        "    buf = bytearray(raw)",
        "    struct.pack_into('>I', buf, _seq_offset(buf), seq & 0xFFFFFFFF)",
        "    return bytes(buf)",
        "",
        "",
        "# method -> (encode_request, decode_request, encode_reply, decode_reply)",
        "METHOD_CODECS = {",
    ]
    for method, (req, rep) in METHOD_SCHEMAS.items():
        enc_req = f"encode_{snake(req)}"
        dec_req = f"decode_{snake(req)}"
        enc_rep = f"encode_{snake(rep)}" if rep else "None"
        dec_rep = f"decode_{snake(rep)}" if rep else "None"
        lines.append(
            f"    {method!r}: ({enc_req}, {dec_req}, {enc_rep}, {dec_rep}),"
        )
    lines.append("}")
    lines.append("")
    return "\n".join(lines)


def main() -> int:
    validate()
    outputs = {PY_OUT: gen_python()}
    check = "--check" in sys.argv
    stale = []
    for path, text in outputs.items():
        if check:
            try:
                with open(path) as fh:
                    if fh.read() != text:
                        stale.append(path)
            except OSError:
                stale.append(path)
        else:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as fh:
                fh.write(text)
            print(f"wrote {path}")
    if check and stale:
        print(f"STALE generated files: {stale} — rerun ray_tpu_torch/_native/schema/gen_wire.py")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
