"""The port's runtime pieces: collective groups over ``torch.distributed``
(``collective``), the SPMD gang of runtime actors (``gang``), placement
groups (``placement_group``) and the scheduling strategies that place an
actor in one (``scheduling_strategies``), and the full-jitter retry delay
(``backoff``)."""
