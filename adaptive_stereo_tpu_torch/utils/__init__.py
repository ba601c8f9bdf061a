"""Utilities (counterpart of adaptive_stereo_tpu/utils/): run provenance,
console metric banners and trials.csv."""
