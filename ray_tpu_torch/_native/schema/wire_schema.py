"""Wire schema — the single source of truth for typed RPC payloads.

Role-equivalent of the reference's protobuf message definitions
(src/ray/protobuf/common.proto :: TaskSpec and friends, SURVEY §2.1 N14).
The envelope (version/kind/msgid/method) is defined by the transport
(_native/src/rpc/transport.cc, wire v1); THIS file types the payloads of
the task/actor/object/lease methods. `gen_wire.py` compiles it into
ray_tpu_torch/_private/wire_gen.py, the Python encoders/decoders. (The
reference also compiles it into its C++ client's header, ROADMAP item 14f.)

Compatibility rules (version-skew safe by construction):
  * payloads stay valid msgpack maps — any generic peer can decode them;
  * decoders IGNORE unknown keys (new fields pass through old peers);
  * decoders DEFAULT missing keys (old senders satisfy new readers);
  * encoders pass through unknown keys so a forwarder never drops fields.

Field types:
  str | bytes | bool | i64 | f64 | raw (any msgpack value, passthrough)
  map_f64 (map str->f64) | msg:<Name> | list_msg:<Name>
  u32fixed — unsigned int always encoded as 5-byte msgpack uint32
             (0xce + 4 bytes) at a deterministic offset so native code
             (or the Python submitter) can patch it without re-encoding;
             must be the FIRST field of its message.
"""

# (name, type, default) triples; order is the canonical wire order.
MESSAGES = {
    # -- task path (N14/N19: push_task request + reply) -------------------
    "Owner": [
        ("worker_id", "str", ""),
        ("address", "raw", None),  # [host, port]
    ],
    "TaskSpec": [
        ("task_id", "str", ""),
        ("job_id", "str", ""),
        ("function_id", "str", ""),
        ("name", "str", ""),
        ("args", "bytes", b""),
        ("num_returns", "i64", 1),
        ("resources", "map_f64", {}),
        ("owner", "msg:Owner", None),
        ("runtime_env", "raw", {}),
        ("scheduling_strategy", "raw", None),
        ("max_retries", "i64", 0),
        ("retry_exceptions", "bool", False),
        ("has_ref_args", "bool", False),
        ("cross_language", "bool", False),
        ("function_ref", "str", ""),
        ("trace_ctx", "raw", None),
    ],
    "ActorTaskSpec": [
        ("seq", "u32fixed", 0),  # first: patchable at a fixed offset
        ("task_id", "str", ""),
        ("job_id", "str", ""),
        ("actor_id", "str", ""),
        ("method", "str", ""),
        ("name", "str", ""),
        ("args", "bytes", b""),
        ("num_returns", "i64", 1),
        ("owner", "msg:Owner", None),
        ("caller_id", "str", ""),
        ("max_retries", "i64", 0),
        ("retry_exceptions", "bool", False),
        ("has_ref_args", "bool", False),
        ("trace_ctx", "raw", None),
    ],
    "ReturnValue": [
        ("kind", "str", "inline"),  # inline | shm | msgpack
        ("data", "bytes", b""),
        ("size", "i64", 0),
        ("location", "raw", None),
    ],
    "TaskReply": [
        ("status", "str", ""),  # ok | error | cancelled
        ("returns", "list_msg:ReturnValue", []),
        ("error", "bytes", b""),       # serialized exception payload
        ("error_text", "str", ""),     # cross-language error detail
    ],
    # -- object owner protocol (N16/N21/N23 methods) ----------------------
    "GetObjectRequest": [
        ("object_id", "str", ""),
    ],
    "GetObjectReply": [
        ("status", "str", ""),  # inline | shm | failed
        ("data", "bytes", b""),
        ("size", "i64", 0),
        ("locations", "raw", []),
        ("error", "bytes", b""),
    ],
    "WaitObjectRequest": [
        ("object_id", "str", ""),
    ],
    "BorrowerUpdate": [
        ("object_id", "str", ""),
        ("borrower", "str", ""),
    ],
    "AddLocationRequest": [
        ("object_id", "str", ""),
        ("location", "raw", None),
        ("size", "i64", 0),
    ],
    "FreeObjectRequest": [
        ("object_id", "str", ""),
    ],
    "CancelTaskRequest": [
        ("task_id", "str", ""),
        ("force", "bool", False),
    ],
    # -- lease path (controller request_lease / agent lease_worker) ------
    "LeaseRequest": [
        ("resources", "map_f64", {}),
        ("job_id", "str", ""),
        ("submitter_node", "str", ""),
        ("scheduling_strategy", "raw", None),
    ],
    "LeaseGrant": [
        ("status", "str", ""),
        ("node_id", "str", ""),
        ("agent_addr", "raw", None),  # [host, port]
    ],
    "WorkerLeaseRequest": [
        ("resources", "map_f64", {}),
        ("runtime_env", "raw", {}),
        ("job_id", "str", ""),
        ("bundle", "raw", None),
    ],
    "WorkerLeaseReply": [
        ("status", "str", ""),
        ("lease_id", "str", ""),
        ("worker_id", "str", ""),
        ("worker_addr", "raw", None),  # [host, port]
        ("error", "str", ""),
    ],
    "ReturnWorkerRequest": [
        ("lease_id", "str", ""),
        ("reusable", "bool", True),
    ],
}

# method name -> (request message, reply message or None)
METHOD_SCHEMAS = {
    "push_task": ("TaskSpec", "TaskReply"),
    "push_actor_task": ("ActorTaskSpec", "TaskReply"),
    "get_object": ("GetObjectRequest", "GetObjectReply"),
    "wait_object": ("WaitObjectRequest", None),
    "add_borrower": ("BorrowerUpdate", None),
    "remove_borrower": ("BorrowerUpdate", None),
    "add_location": ("AddLocationRequest", None),
    "free_object": ("FreeObjectRequest", None),
    "cancel_task": ("CancelTaskRequest", None),
    "request_lease": ("LeaseRequest", "LeaseGrant"),
    "lease_worker": ("WorkerLeaseRequest", "WorkerLeaseReply"),
    "return_worker": ("ReturnWorkerRequest", None),
}
