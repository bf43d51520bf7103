"""The science pipelines of the port, written against its `lixirnet`:
``bayesian_inference_rate_based`` (the Bayesian-inference trial) and
their shared helpers (``pipeline_setup``)."""
