from . import v1alpha1, v1alpha2

__all__ = ["v1alpha1", "v1alpha2"]
