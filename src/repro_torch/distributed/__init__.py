from . import collectives, mesh, planner

__all__ = ["collectives", "mesh", "planner"]
