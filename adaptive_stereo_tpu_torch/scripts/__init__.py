"""The paper-protocol runners on the port (counterparts of the repo's
scripts/run_paper_suite.py, make_readiness_minidata.py,
run_readiness_drill.py, run_paper_scale_synth.py,
run_gtfree_guard_study.py and examples/synthetic_pipeline_demo.py). Each keeps its JAX counterpart's
name, flags and output lines, takes --device (default cuda), and runs as
`python -m adaptive_stereo_tpu_torch.scripts.<name>`."""
