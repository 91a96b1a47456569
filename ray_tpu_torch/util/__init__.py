"""The port's runtime pieces: collective groups over ``torch.distributed``
(``collective``) and the single-host gang of worker processes (``gang``)."""
