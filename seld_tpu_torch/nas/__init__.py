"""Neural-architecture-search tools (seld_tpu/nas); so far the analytic
complexity of the SS5 model family."""
