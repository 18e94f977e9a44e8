from .triplane import TriPlaneSemanticEntangleGenerator, build_generator

__all__ = ["TriPlaneSemanticEntangleGenerator", "build_generator"]
