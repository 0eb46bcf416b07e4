from .synthetic import embedded_chain_stream, random_stream, sym26
from .spikes import partition_windows

__all__ = ["embedded_chain_stream", "random_stream", "sym26",
           "partition_windows"]
