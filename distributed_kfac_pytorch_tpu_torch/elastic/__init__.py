"""Elastic training: the world as a resume-time parameter (PyTorch port
of ``distributed_kfac_pytorch_tpu/elastic``).

  - :mod:`elastic.topology`: every bundle records the saving world
    (``topo_*`` scalars);
  - :mod:`elastic.reshard`: gather the saved row stacks into a canonical
    per-factor form and repack them for the live world (a lossless
    permutation, so N -> M -> N resumes continue bit for bit);
  - the resume integration is ``resilience.cli.resume(elastic=
    ElasticResume(kfac))``, and the ``resize@K->N`` / ``slice-loss@K->S``
    fault kinds with ``resilience.chaos`` drive a change of world.
"""

from distributed_kfac_pytorch_tpu_torch.elastic.reshard import (  # noqa: F401
    ElasticResume,
    reshard_state_dict,
)
from distributed_kfac_pytorch_tpu_torch.elastic.topology import (  # noqa: F401
    TopologySpec,
)
