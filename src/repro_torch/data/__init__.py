from repro_torch.data.synthetic import (  # noqa: F401
    make_batch, token_stream, SyntheticCorpus,
    correlated_tenant_load, heavy_tail_load,
)
