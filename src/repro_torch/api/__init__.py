from repro_torch.api.variants import DEFAULT_VARIANTS, QuantRecipe, VariantSpec

__all__ = ["DEFAULT_VARIANTS", "QuantRecipe", "VariantSpec"]
