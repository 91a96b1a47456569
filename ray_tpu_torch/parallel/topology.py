"""Two-tier topology: meshes whose ranks span fast domains over a slower
network.

Port of ray_tpu's ``parallel/topology.py``. There a TPU pod slice is one
ICI domain, and training across slices rides the data-center network
(DCN); here a domain is a host, whose cards talk over NVLink, and the tier
between hosts is the cluster network. The mesh encodes that boundary:
collective-heavy axes (tp, sp, ...) stay inside a domain, cheap ones (the
dp gradient sync) cross domains, so no tensor-parallel all-reduce is routed
between hosts.

``SliceTopology`` keeps the reference's names and validation. Its
``build_mesh`` returns a ``DeviceMesh`` over the initialized process group,
its ranks arranged [domain, in-domain] with the DCN axes outermost, so any
collective over an ICI axis touches one domain only. A rank's domain is its
host by default, gathered once over the process group; ``domains=`` (a list
of rank lists) sets it, which is how the CPU twin groups gloo ranks of one
host into domains, as the reference's CPU twin lets a process play a slice.
``hierarchical_psum`` reduces tier by tier on that mesh: one ``all_reduce``
per ICI axis, then one per DCN axis.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Mapping, Sequence

import numpy as np
import torch

from ray_tpu_torch import resolve_device


def _host_domains() -> list[list[int]]:
    """Every rank's host, gathered once over the process group: one rank
    list a host, hosts in the order of their lowest rank."""
    import torch.distributed as dist

    hosts: list = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    domains: dict[str, list[int]] = {}
    for rank, host in enumerate(hosts):
        domains.setdefault(host, []).append(rank)
    return list(domains.values())


def domain_grid(domains: Sequence[Sequence[int]], dcn_shape: Sequence[int],
                ici_shape: Sequence[int]) -> np.ndarray:
    """The mesh's rank grid: one row a domain (in the order given), each
    row's ranks ascending, reshaped to ``(*dcn_shape, *ici_shape)``. Raises
    as the reference's ``build_mesh`` does when the domains do not match
    the shapes."""
    num_slices, per = math.prod(dcn_shape), math.prod(ici_shape)
    if len(domains) != num_slices:
        raise ValueError(
            f"topology wants {num_slices} slices "
            f"(prod of dcn_axes), runtime has {len(domains)} "
            f"ICI domains"
        )
    rows = []
    for key, members in enumerate(domains):
        members = sorted(int(r) for r in members)
        if len(members) != per:
            raise ValueError(
                f"slice {key} has {len(members)} devices, topology "
                f"wants {per} (prod of ici_axes)"
            )
        rows.append(members)
    return np.array(rows, dtype=np.int64).reshape(*dcn_shape, *ici_shape)


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """Axis layout for a two-tier mesh.

    ici_axes -- named axes laid out WITHIN a domain (tp/sp/fsdp...).
    dcn_axes -- named axes laid out ACROSS domains (usually {"dp": n}).

    prod(dcn_axes) must equal the number of domains; prod(ici_axes) the
    ranks per domain.
    """

    ici_axes: Mapping[str, int]
    dcn_axes: Mapping[str, int]

    def __post_init__(self):
        overlap = set(self.ici_axes) & set(self.dcn_axes)
        if overlap:
            raise ValueError(f"axes on both tiers: {sorted(overlap)}")
        if not self.ici_axes or not self.dcn_axes:
            raise ValueError("both ici_axes and dcn_axes must be non-empty")

    @property
    def num_slices(self) -> int:
        return math.prod(self.dcn_axes.values())

    @property
    def devices_per_slice(self) -> int:
        return math.prod(self.ici_axes.values())

    def axis_names(self) -> tuple[str, ...]:
        return (*self.dcn_axes.keys(), *self.ici_axes.keys())

    def build_mesh(self, device=None, domains: Sequence[Sequence[int]] | None = None):
        """A ``DeviceMesh`` with the DCN axes outermost over the ranks
        grouped by domain (``domains``, or each rank's host), on the card
        unless ``device`` says otherwise. Every rank of the process group
        calls it, as every rank builds a ``DeviceMesh``; with no process
        group up, a topology of one rank starts its own."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ray_tpu_torch.parallel.mesh import MeshSpec, _init_single_rank

        # The axis names and sizes pass the port's mesh validation; the
        # rank order is the topology's, not MeshSpec's.
        spec = MeshSpec({**self.dcn_axes, **self.ici_axes})
        device = resolve_device(device)
        if not dist.is_initialized():
            if spec.size != 1:
                raise RuntimeError(
                    f"a mesh of {spec.size} devices needs an initialized process group of "
                    f"{spec.size} ranks (torch.distributed.init_process_group)")
            _init_single_rank(device)
        if domains is None:
            domains = _host_domains()
        grid = domain_grid(domains, tuple(self.dcn_axes.values()),
                           tuple(self.ici_axes.values()))
        world = dist.get_world_size()
        if grid.size != world or sorted(grid.reshape(-1).tolist()) != list(range(world)):
            raise ValueError(f"the domains {[list(d) for d in domains]} do not cover the "
                             f"process group's {world} ranks once each")
        if device.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        return DeviceMesh(device.type, torch.from_numpy(grid), mesh_dim_names=self.axis_names())

    # -- hierarchical collectives ---------------------------------------
    def hierarchical_psum(self, x: torch.Tensor, mesh, *, ici: bool = True,
                          dcn: bool = True) -> torch.Tensor:
        """``x`` summed tier by tier over ``mesh`` (this topology's
        ``build_mesh``): within the domain first (one all-reduce per ICI
        axis), then across domains (one per DCN axis): the two-tier
        gradient sync. Returns a new tensor."""
        import torch.distributed as dist

        out = x.detach().clone()
        names = []
        if ici:
            names += list(self.ici_axes)
        if dcn:
            names += list(self.dcn_axes)
        for name in names:
            dist.all_reduce(out, group=mesh.get_group(name))
        return out

    def hierarchical_pmean(self, x: torch.Tensor, mesh, *, ici: bool = True,
                           dcn: bool = True) -> torch.Tensor:
        """Tier-ordered mean: :meth:`hierarchical_psum` divided by the
        number of participants actually reduced over."""
        total = self.hierarchical_psum(x, mesh, ici=ici, dcn=dcn)
        participants = 1
        if ici:
            participants *= self.devices_per_slice
        if dcn:
            participants *= self.num_slices
        return total / participants

    def grad_sync_axes(self) -> tuple[str, ...]:
        """The DCN axes a data-parallel gradient sync reduces over."""
        return tuple(self.dcn_axes.keys())

