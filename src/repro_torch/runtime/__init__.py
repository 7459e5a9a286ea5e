from .fault_tolerance import ElasticMesh, StragglerDetector, TrainSupervisor
__all__ = ["ElasticMesh", "StragglerDetector", "TrainSupervisor"]
