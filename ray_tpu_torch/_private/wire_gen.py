"""GENERATED by ray_tpu_torch/_native/schema/gen_wire.py from wire_schema.py
— do not edit by hand; rerun the generator (a test runs --check).

Typed payload codecs for the task/actor/object/lease RPC methods
(reference protobuf-message role, SURVEY N14). Payloads stay plain
msgpack maps: decoders ignore unknown keys and default missing ones,
encoders pass unknown keys through — version skew is safe both ways.
"""

from __future__ import annotations

import struct

import msgpack


def _packb(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _unpackb(raw):
    return msgpack.unpackb(raw, raw=False, strict_map_key=False)


OWNER_KEYS = frozenset(('worker_id', 'address',))


def encode_owner(d: dict) -> bytes:
    """Owner -> canonical msgpack bytes."""
    out = {
        'worker_id': d.get('worker_id', ''),
        'address': d.get('address', None),
    }
    for k, v in d.items():
        if k not in OWNER_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_owner(raw: bytes) -> dict:
    """msgpack bytes -> Owner dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'worker_id' not in d:
        d['worker_id'] = ''
    if 'address' not in d:
        d['address'] = None
    return d

TASK_SPEC_KEYS = frozenset(('task_id', 'job_id', 'function_id', 'name', 'args', 'num_returns', 'resources', 'owner', 'runtime_env', 'scheduling_strategy', 'max_retries', 'retry_exceptions', 'has_ref_args', 'cross_language', 'function_ref', 'trace_ctx',))


def encode_task_spec(d: dict) -> bytes:
    """TaskSpec -> canonical msgpack bytes."""
    out = {
        'task_id': d.get('task_id', ''),
        'job_id': d.get('job_id', ''),
        'function_id': d.get('function_id', ''),
        'name': d.get('name', ''),
        'args': d.get('args', b''),
        'num_returns': d.get('num_returns', 1),
        'resources': d.get('resources', {}),
        'owner': d.get('owner', None),
        'runtime_env': d.get('runtime_env', {}),
        'scheduling_strategy': d.get('scheduling_strategy', None),
        'max_retries': d.get('max_retries', 0),
        'retry_exceptions': d.get('retry_exceptions', False),
        'has_ref_args': d.get('has_ref_args', False),
        'cross_language': d.get('cross_language', False),
        'function_ref': d.get('function_ref', ''),
        'trace_ctx': d.get('trace_ctx', None),
    }
    for k, v in d.items():
        if k not in TASK_SPEC_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_task_spec(raw: bytes) -> dict:
    """msgpack bytes -> TaskSpec dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'task_id' not in d:
        d['task_id'] = ''
    if 'job_id' not in d:
        d['job_id'] = ''
    if 'function_id' not in d:
        d['function_id'] = ''
    if 'name' not in d:
        d['name'] = ''
    if 'args' not in d:
        d['args'] = b''
    if 'num_returns' not in d:
        d['num_returns'] = 1
    if 'resources' not in d:
        d['resources'] = {}
    if 'owner' not in d:
        d['owner'] = None
    if 'runtime_env' not in d:
        d['runtime_env'] = {}
    if 'scheduling_strategy' not in d:
        d['scheduling_strategy'] = None
    if 'max_retries' not in d:
        d['max_retries'] = 0
    if 'retry_exceptions' not in d:
        d['retry_exceptions'] = False
    if 'has_ref_args' not in d:
        d['has_ref_args'] = False
    if 'cross_language' not in d:
        d['cross_language'] = False
    if 'function_ref' not in d:
        d['function_ref'] = ''
    if 'trace_ctx' not in d:
        d['trace_ctx'] = None
    return d

ACTOR_TASK_SPEC_KEYS = frozenset(('seq', 'task_id', 'job_id', 'actor_id', 'method', 'name', 'args', 'num_returns', 'owner', 'caller_id', 'max_retries', 'retry_exceptions', 'has_ref_args', 'trace_ctx',))


def encode_actor_task_spec(d: dict) -> bytes:
    """ActorTaskSpec -> canonical msgpack bytes."""
    out = {
        'seq': 0xFFFFFFFF,
        'task_id': d.get('task_id', ''),
        'job_id': d.get('job_id', ''),
        'actor_id': d.get('actor_id', ''),
        'method': d.get('method', ''),
        'name': d.get('name', ''),
        'args': d.get('args', b''),
        'num_returns': d.get('num_returns', 1),
        'owner': d.get('owner', None),
        'caller_id': d.get('caller_id', ''),
        'max_retries': d.get('max_retries', 0),
        'retry_exceptions': d.get('retry_exceptions', False),
        'has_ref_args': d.get('has_ref_args', False),
        'trace_ctx': d.get('trace_ctx', None),
    }
    for k, v in d.items():
        if k not in ACTOR_TASK_SPEC_KEYS:
            out[k] = v  # forward-compat passthrough
    raw = bytearray(_packb(out))
    struct.pack_into('>I', raw, _seq_offset(raw), int(d.get('seq', 0)) & 0xFFFFFFFF)
    return bytes(raw)


def decode_actor_task_spec(raw: bytes) -> dict:
    """msgpack bytes -> ActorTaskSpec dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'seq' not in d:
        d['seq'] = 0
    if 'task_id' not in d:
        d['task_id'] = ''
    if 'job_id' not in d:
        d['job_id'] = ''
    if 'actor_id' not in d:
        d['actor_id'] = ''
    if 'method' not in d:
        d['method'] = ''
    if 'name' not in d:
        d['name'] = ''
    if 'args' not in d:
        d['args'] = b''
    if 'num_returns' not in d:
        d['num_returns'] = 1
    if 'owner' not in d:
        d['owner'] = None
    if 'caller_id' not in d:
        d['caller_id'] = ''
    if 'max_retries' not in d:
        d['max_retries'] = 0
    if 'retry_exceptions' not in d:
        d['retry_exceptions'] = False
    if 'has_ref_args' not in d:
        d['has_ref_args'] = False
    if 'trace_ctx' not in d:
        d['trace_ctx'] = None
    return d

RETURN_VALUE_KEYS = frozenset(('kind', 'data', 'size', 'location',))


def encode_return_value(d: dict) -> bytes:
    """ReturnValue -> canonical msgpack bytes."""
    out = {
        'kind': d.get('kind', 'inline'),
        'data': d.get('data', b''),
        'size': d.get('size', 0),
        'location': d.get('location', None),
    }
    for k, v in d.items():
        if k not in RETURN_VALUE_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_return_value(raw: bytes) -> dict:
    """msgpack bytes -> ReturnValue dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'kind' not in d:
        d['kind'] = 'inline'
    if 'data' not in d:
        d['data'] = b''
    if 'size' not in d:
        d['size'] = 0
    if 'location' not in d:
        d['location'] = None
    return d

TASK_REPLY_KEYS = frozenset(('status', 'returns', 'error', 'error_text',))


def encode_task_reply(d: dict) -> bytes:
    """TaskReply -> canonical msgpack bytes."""
    out = {
        'status': d.get('status', ''),
        'returns': d.get('returns', []),
        'error': d.get('error', b''),
        'error_text': d.get('error_text', ''),
    }
    for k, v in d.items():
        if k not in TASK_REPLY_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_task_reply(raw: bytes) -> dict:
    """msgpack bytes -> TaskReply dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'status' not in d:
        d['status'] = ''
    if 'returns' not in d:
        d['returns'] = []
    if 'error' not in d:
        d['error'] = b''
    if 'error_text' not in d:
        d['error_text'] = ''
    return d

GET_OBJECT_REQUEST_KEYS = frozenset(('object_id',))


def encode_get_object_request(d: dict) -> bytes:
    """GetObjectRequest -> canonical msgpack bytes."""
    out = {
        'object_id': d.get('object_id', ''),
    }
    for k, v in d.items():
        if k not in GET_OBJECT_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_get_object_request(raw: bytes) -> dict:
    """msgpack bytes -> GetObjectRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'object_id' not in d:
        d['object_id'] = ''
    return d

GET_OBJECT_REPLY_KEYS = frozenset(('status', 'data', 'size', 'locations', 'error',))


def encode_get_object_reply(d: dict) -> bytes:
    """GetObjectReply -> canonical msgpack bytes."""
    out = {
        'status': d.get('status', ''),
        'data': d.get('data', b''),
        'size': d.get('size', 0),
        'locations': d.get('locations', []),
        'error': d.get('error', b''),
    }
    for k, v in d.items():
        if k not in GET_OBJECT_REPLY_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_get_object_reply(raw: bytes) -> dict:
    """msgpack bytes -> GetObjectReply dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'status' not in d:
        d['status'] = ''
    if 'data' not in d:
        d['data'] = b''
    if 'size' not in d:
        d['size'] = 0
    if 'locations' not in d:
        d['locations'] = []
    if 'error' not in d:
        d['error'] = b''
    return d

WAIT_OBJECT_REQUEST_KEYS = frozenset(('object_id',))


def encode_wait_object_request(d: dict) -> bytes:
    """WaitObjectRequest -> canonical msgpack bytes."""
    out = {
        'object_id': d.get('object_id', ''),
    }
    for k, v in d.items():
        if k not in WAIT_OBJECT_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_wait_object_request(raw: bytes) -> dict:
    """msgpack bytes -> WaitObjectRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'object_id' not in d:
        d['object_id'] = ''
    return d

BORROWER_UPDATE_KEYS = frozenset(('object_id', 'borrower',))


def encode_borrower_update(d: dict) -> bytes:
    """BorrowerUpdate -> canonical msgpack bytes."""
    out = {
        'object_id': d.get('object_id', ''),
        'borrower': d.get('borrower', ''),
    }
    for k, v in d.items():
        if k not in BORROWER_UPDATE_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_borrower_update(raw: bytes) -> dict:
    """msgpack bytes -> BorrowerUpdate dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'object_id' not in d:
        d['object_id'] = ''
    if 'borrower' not in d:
        d['borrower'] = ''
    return d

ADD_LOCATION_REQUEST_KEYS = frozenset(('object_id', 'location', 'size',))


def encode_add_location_request(d: dict) -> bytes:
    """AddLocationRequest -> canonical msgpack bytes."""
    out = {
        'object_id': d.get('object_id', ''),
        'location': d.get('location', None),
        'size': d.get('size', 0),
    }
    for k, v in d.items():
        if k not in ADD_LOCATION_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_add_location_request(raw: bytes) -> dict:
    """msgpack bytes -> AddLocationRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'object_id' not in d:
        d['object_id'] = ''
    if 'location' not in d:
        d['location'] = None
    if 'size' not in d:
        d['size'] = 0
    return d

FREE_OBJECT_REQUEST_KEYS = frozenset(('object_id',))


def encode_free_object_request(d: dict) -> bytes:
    """FreeObjectRequest -> canonical msgpack bytes."""
    out = {
        'object_id': d.get('object_id', ''),
    }
    for k, v in d.items():
        if k not in FREE_OBJECT_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_free_object_request(raw: bytes) -> dict:
    """msgpack bytes -> FreeObjectRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'object_id' not in d:
        d['object_id'] = ''
    return d

CANCEL_TASK_REQUEST_KEYS = frozenset(('task_id', 'force',))


def encode_cancel_task_request(d: dict) -> bytes:
    """CancelTaskRequest -> canonical msgpack bytes."""
    out = {
        'task_id': d.get('task_id', ''),
        'force': d.get('force', False),
    }
    for k, v in d.items():
        if k not in CANCEL_TASK_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_cancel_task_request(raw: bytes) -> dict:
    """msgpack bytes -> CancelTaskRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'task_id' not in d:
        d['task_id'] = ''
    if 'force' not in d:
        d['force'] = False
    return d

LEASE_REQUEST_KEYS = frozenset(('resources', 'job_id', 'submitter_node', 'scheduling_strategy',))


def encode_lease_request(d: dict) -> bytes:
    """LeaseRequest -> canonical msgpack bytes."""
    out = {
        'resources': d.get('resources', {}),
        'job_id': d.get('job_id', ''),
        'submitter_node': d.get('submitter_node', ''),
        'scheduling_strategy': d.get('scheduling_strategy', None),
    }
    for k, v in d.items():
        if k not in LEASE_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_lease_request(raw: bytes) -> dict:
    """msgpack bytes -> LeaseRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'resources' not in d:
        d['resources'] = {}
    if 'job_id' not in d:
        d['job_id'] = ''
    if 'submitter_node' not in d:
        d['submitter_node'] = ''
    if 'scheduling_strategy' not in d:
        d['scheduling_strategy'] = None
    return d

LEASE_GRANT_KEYS = frozenset(('status', 'node_id', 'agent_addr',))


def encode_lease_grant(d: dict) -> bytes:
    """LeaseGrant -> canonical msgpack bytes."""
    out = {
        'status': d.get('status', ''),
        'node_id': d.get('node_id', ''),
        'agent_addr': d.get('agent_addr', None),
    }
    for k, v in d.items():
        if k not in LEASE_GRANT_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_lease_grant(raw: bytes) -> dict:
    """msgpack bytes -> LeaseGrant dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'status' not in d:
        d['status'] = ''
    if 'node_id' not in d:
        d['node_id'] = ''
    if 'agent_addr' not in d:
        d['agent_addr'] = None
    return d

WORKER_LEASE_REQUEST_KEYS = frozenset(('resources', 'runtime_env', 'job_id', 'bundle',))


def encode_worker_lease_request(d: dict) -> bytes:
    """WorkerLeaseRequest -> canonical msgpack bytes."""
    out = {
        'resources': d.get('resources', {}),
        'runtime_env': d.get('runtime_env', {}),
        'job_id': d.get('job_id', ''),
        'bundle': d.get('bundle', None),
    }
    for k, v in d.items():
        if k not in WORKER_LEASE_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_worker_lease_request(raw: bytes) -> dict:
    """msgpack bytes -> WorkerLeaseRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'resources' not in d:
        d['resources'] = {}
    if 'runtime_env' not in d:
        d['runtime_env'] = {}
    if 'job_id' not in d:
        d['job_id'] = ''
    if 'bundle' not in d:
        d['bundle'] = None
    return d

WORKER_LEASE_REPLY_KEYS = frozenset(('status', 'lease_id', 'worker_id', 'worker_addr', 'error',))


def encode_worker_lease_reply(d: dict) -> bytes:
    """WorkerLeaseReply -> canonical msgpack bytes."""
    out = {
        'status': d.get('status', ''),
        'lease_id': d.get('lease_id', ''),
        'worker_id': d.get('worker_id', ''),
        'worker_addr': d.get('worker_addr', None),
        'error': d.get('error', ''),
    }
    for k, v in d.items():
        if k not in WORKER_LEASE_REPLY_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_worker_lease_reply(raw: bytes) -> dict:
    """msgpack bytes -> WorkerLeaseReply dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'status' not in d:
        d['status'] = ''
    if 'lease_id' not in d:
        d['lease_id'] = ''
    if 'worker_id' not in d:
        d['worker_id'] = ''
    if 'worker_addr' not in d:
        d['worker_addr'] = None
    if 'error' not in d:
        d['error'] = ''
    return d

RETURN_WORKER_REQUEST_KEYS = frozenset(('lease_id', 'reusable',))


def encode_return_worker_request(d: dict) -> bytes:
    """ReturnWorkerRequest -> canonical msgpack bytes."""
    out = {
        'lease_id': d.get('lease_id', ''),
        'reusable': d.get('reusable', True),
    }
    for k, v in d.items():
        if k not in RETURN_WORKER_REQUEST_KEYS:
            out[k] = v  # forward-compat passthrough
    return _packb(out)


def decode_return_worker_request(raw: bytes) -> dict:
    """msgpack bytes -> ReturnWorkerRequest dict (missing keys defaulted,
    unknown keys preserved)."""
    d = _unpackb(raw)
    if 'lease_id' not in d:
        d['lease_id'] = ''
    if 'reusable' not in d:
        d['reusable'] = True
    return d


def make_task_spec_parts(d: dict) -> tuple:
    """Precompile TaskSpec splice parts from a template:
    encode_task_spec(d | {task_id, args}) ==
    p0 + packb(task_id) + p1 + packb(args) + p2, with the
    u32fixed seq (if any) patched at seq_off. Unknown template
    keys land in p2 (encoder passthrough order)."""
    unknown = [(k, v) for k, v in d.items() if k not in TASK_SPEC_KEYS]
    p = [_map_header(16 + len(unknown))]
    seq_off = -1
    p.append(_packb('task_id'))
    p0 = b''.join(p)
    p = []
    p.append(_packb('job_id') + _packb(d.get('job_id', '')))
    p.append(_packb('function_id') + _packb(d.get('function_id', '')))
    p.append(_packb('name') + _packb(d.get('name', '')))
    p.append(_packb('args'))
    p1 = b''.join(p)
    p = []
    p.append(_packb('num_returns') + _packb(d.get('num_returns', 1)))
    p.append(_packb('resources') + _packb(d.get('resources', {})))
    p.append(_packb('owner') + _packb(d.get('owner', None)))
    p.append(_packb('runtime_env') + _packb(d.get('runtime_env', {})))
    p.append(_packb('scheduling_strategy') + _packb(d.get('scheduling_strategy', None)))
    p.append(_packb('max_retries') + _packb(d.get('max_retries', 0)))
    p.append(_packb('retry_exceptions') + _packb(d.get('retry_exceptions', False)))
    p.append(_packb('has_ref_args') + _packb(d.get('has_ref_args', False)))
    p.append(_packb('cross_language') + _packb(d.get('cross_language', False)))
    p.append(_packb('function_ref') + _packb(d.get('function_ref', '')))
    p.append(_packb('trace_ctx') + _packb(d.get('trace_ctx', None)))
    for k, v in unknown:
        p.append(_packb(k) + _packb(v))
    p2 = b''.join(p)
    return p0, p1, p2, seq_off


def make_actor_task_spec_parts(d: dict) -> tuple:
    """Precompile ActorTaskSpec splice parts from a template:
    encode_actor_task_spec(d | {task_id, args}) ==
    p0 + packb(task_id) + p1 + packb(args) + p2, with the
    u32fixed seq (if any) patched at seq_off. Unknown template
    keys land in p2 (encoder passthrough order)."""
    unknown = [(k, v) for k, v in d.items() if k not in ACTOR_TASK_SPEC_KEYS]
    p = [_map_header(14 + len(unknown))]
    seq_off = -1
    p.append(_packb('seq'))
    seq_off = sum(len(x) for x in p) + 1
    p.append(b'\xce\x00\x00\x00\x00')
    p.append(_packb('task_id'))
    p0 = b''.join(p)
    p = []
    p.append(_packb('job_id') + _packb(d.get('job_id', '')))
    p.append(_packb('actor_id') + _packb(d.get('actor_id', '')))
    p.append(_packb('method') + _packb(d.get('method', '')))
    p.append(_packb('name') + _packb(d.get('name', '')))
    p.append(_packb('args'))
    p1 = b''.join(p)
    p = []
    p.append(_packb('num_returns') + _packb(d.get('num_returns', 1)))
    p.append(_packb('owner') + _packb(d.get('owner', None)))
    p.append(_packb('caller_id') + _packb(d.get('caller_id', '')))
    p.append(_packb('max_retries') + _packb(d.get('max_retries', 0)))
    p.append(_packb('retry_exceptions') + _packb(d.get('retry_exceptions', False)))
    p.append(_packb('has_ref_args') + _packb(d.get('has_ref_args', False)))
    p.append(_packb('trace_ctx') + _packb(d.get('trace_ctx', None)))
    for k, v in unknown:
        p.append(_packb(k) + _packb(v))
    p2 = b''.join(p)
    return p0, p1, p2, seq_off


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 65536:
        return bytes([0xDE, n >> 8, n & 0xFF])
    raise ValueError('map too large')


def splice(parts: tuple, var1, var2, seq: int = 0) -> bytes:
    """Pure-Python splice twin of the native submit path (and the
    fallback when the _fastlane extension is unavailable)."""
    p0, p1, p2, seq_off = parts
    out = p0 + _packb(var1) + p1 + _packb(var2) + p2
    if seq_off >= 0:
        buf = bytearray(out)
        struct.pack_into('>I', buf, seq_off, seq & 0xFFFFFFFF)
        out = bytes(buf)
    return out


def _seq_offset(raw) -> int:
    """Offset of the 4 seq bytes in a u32fixed-first message."""
    b0 = raw[0]
    if 0x80 <= b0 <= 0x8F:
        header = 1
    elif b0 == 0xDE:
        header = 3
    elif b0 == 0xDF:
        header = 5
    else:
        raise ValueError('not a msgpack map')
    if bytes(raw[header:header + 5]) != b'\xa3seq\xce':
        raise ValueError('seq field not first / not u32fixed')
    return header + 5


def patch_seq(raw: bytes, seq: int) -> bytes:
    """Rewrite the seq of an encoded u32fixed-first message in
    place — no re-encode (the native submitter uses the same
    offsets)."""
    buf = bytearray(raw)
    struct.pack_into('>I', buf, _seq_offset(buf), seq & 0xFFFFFFFF)
    return bytes(buf)


# method -> (encode_request, decode_request, encode_reply, decode_reply)
METHOD_CODECS = {
    'push_task': (encode_task_spec, decode_task_spec, encode_task_reply, decode_task_reply),
    'push_actor_task': (encode_actor_task_spec, decode_actor_task_spec, encode_task_reply, decode_task_reply),
    'get_object': (encode_get_object_request, decode_get_object_request, encode_get_object_reply, decode_get_object_reply),
    'wait_object': (encode_wait_object_request, decode_wait_object_request, None, None),
    'add_borrower': (encode_borrower_update, decode_borrower_update, None, None),
    'remove_borrower': (encode_borrower_update, decode_borrower_update, None, None),
    'add_location': (encode_add_location_request, decode_add_location_request, None, None),
    'free_object': (encode_free_object_request, decode_free_object_request, None, None),
    'cancel_task': (encode_cancel_task_request, decode_cancel_task_request, None, None),
    'request_lease': (encode_lease_request, decode_lease_request, encode_lease_grant, decode_lease_grant),
    'lease_worker': (encode_worker_lease_request, decode_worker_lease_request, encode_worker_lease_reply, decode_worker_lease_reply),
    'return_worker': (encode_return_worker_request, decode_return_worker_request, None, None),
}
