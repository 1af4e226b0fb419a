"""The validation and tutorial programs, on the device.

One module per program, each with ``run(..., device="cuda", seed=...)``
(the study, returning its numbers) and ``main(argv=None)`` (its command
line: ``python -m mind_the_gaps_tpu_torch.examples.<name>``):

- ``validation_pvalue_calibration``: K batched experiments under the null,
  the KS test of their bootstrap p-values (Gaussian or lognormal flux);
- ``validation_detection_power``: the detection fraction against the
  strength of an injected QPO;
- ``validation_full_pipeline_calibration``: K complete ``protassov_lrt``
  calls under the null, the KS test of their p-values;
- ``tutorial_ppp``: the posterior-predictive LRT tutorial, with or without
  an injected QPO;
- ``tutorial_model_selection``: AICc and residual KS over four kernels;
- ``study_celerite_variance``, ``study_poisson_level`` and
  ``study_lomb_scargle_biases``: the convention studies, with their
  assertions;
- ``lrt_10k``: the production scenario, one 10,000-simulation LRT at
  N=5000, timed (over the process mesh under ``torchrun``);
- ``make_notebooks``: generates and executes the five tutorial notebooks
  into ``notebooks/`` (on the CPU; needs nbformat and nbclient).

Nothing runs at import.
"""
