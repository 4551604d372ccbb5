"""tune/ — the autotuner with a persisted decision cache — port of
``neutronstarlite_tpu/tune/``.

``DIST_PATH:auto``, ``KERNEL:auto``, ``ELL_LEVELS:auto``,
``WIRE_DTYPE:auto``, ``MESH:auto`` (or ``NTS_MESH=auto``) and
``SAMPLE_PIPELINE:auto`` resolve from measurement:

- :mod:`tune.space`: the typed candidate space, each tuple probed through
  the trainer class's own funnel check (``check_cfg``);
- :mod:`tune.runner`: an analytic prior from
  ``tools/wire_accounting.predict_all`` prunes the space, then short timed
  forward and backward trials (the twins on one device, the real exchanges
  over ranks) score the survivors;
- :mod:`tune.cache`: the per-graph decision cache under ``NTS_TUNE_DIR``,
  keyed by (graph digest, family, P, layers, backend), schema-versioned,
  published atomically, loud when stale;
- :mod:`tune.select`: the funnel's resolution hook and the re-consultation
  for a survivor replan.

Knobs: ``NTS_TUNE=off|cached|measure``, ``NTS_TUNE_DIR``,
``NTS_TUNE_STEPS`` (timed calls per trial), ``NTS_TUNE_MAX_TRIALS`` (the
trial budget after the prior's pruning); docs/TUNING.md has the contract.
"""

from neutronstarlite_torch.tune.cache import (  # noqa: F401
    CacheKey,
    backend_fingerprint,
    tune_dir,
    tune_mode,
)
from neutronstarlite_torch.tune.select import (  # noqa: F401
    reconsult_for_replan,
    resolve_auto_knobs,
)
from neutronstarlite_torch.tune.space import (  # noqa: F401
    AXES,
    Candidate,
    enumerate_candidates,
    family_of,
)
