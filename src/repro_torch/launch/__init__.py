from repro_torch.launch.mesh import make_production_mesh, mesh_config

__all__ = ["make_production_mesh", "mesh_config"]
