"""Entry points (twin of ``repro/launch``): ``serve``, ``train``,
``distributed``, and launch planning: ``specs``, ``mesh`` and the
``meta``-device ``dryrun``."""
