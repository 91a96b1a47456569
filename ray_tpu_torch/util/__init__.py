"""The port's runtime pieces: collective groups over ``torch.distributed``
(``collective``), the single-host gang of worker processes (``gang``) and
the full-jitter retry delay (``backoff``)."""
