"""Scene file readers; counterpart of gravit_tpu/scene/readers/."""
