"""Policy core: rule model, repository, resolution."""

from cilium_tpu_torch.policy.search import Decision, Port, SearchContext, Tracing  # noqa: F401
