"""Device selection and depth visualization (counterpart of ``sinnerf_tpu/utils``)."""
