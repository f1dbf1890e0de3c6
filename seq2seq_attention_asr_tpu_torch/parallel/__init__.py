"""dp x sp parallelism over torch.distributed (seq2seq_attention_asr_tpu/parallel).

``dp`` and ``seq_attention`` import the trainer and the decoder, which
import ``comm``; import them by name (``from ..parallel import dp``)."""

from . import comm, mesh, multihost  # noqa: F401
from .mesh import make_mesh  # noqa: F401
