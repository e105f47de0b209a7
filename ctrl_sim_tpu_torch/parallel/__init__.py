"""Process meshes over torch.distributed for data-parallel training and
env-sharded rollouts."""

from ctrl_sim_tpu_torch.parallel.mesh import MeshSpec, init_distributed, make_mesh

__all__ = ["MeshSpec", "init_distributed", "make_mesh"]
