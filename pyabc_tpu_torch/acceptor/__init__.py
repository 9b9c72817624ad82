from .acceptor import UniformAcceptor

__all__ = ["UniformAcceptor"]
