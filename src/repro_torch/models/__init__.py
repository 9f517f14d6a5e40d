"""The LM stack (port of ``repro.models``): ``layers``,
``recurrent``, ``transformer``, ``encdec`` and the ``model`` façade.  No
module here reaches a kernel of the reference: attention, the recurrences
and the MoE are plain tensor ops, and every large product is a
``torch.matmul``/``einsum``."""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
