"""Part of the PyTorch port (see variantformer_tpu_torch/__init__.py)."""

# The public surfaces, each a submodule:
#   variantformer_tpu_torch.api.vcfprocessor     VCFProcessor, DataSources (vcf2exp)
#   variantformer_tpu_torch.api.variantprocessor VariantProcessor (VEP / eQTL)
#   variantformer_tpu_torch.api.model_manager    ModelManager (reference .pth load)
#   variantformer_tpu_torch.api.ad_risk          ADrisk, ADriskFromVCF (own GBT engine)
#   variantformer_tpu_torch.api.sweeps           genome_wide_expression, saturation_scan
#   variantformer_tpu_torch.api.anatomagram      anatomagram_html + adapters
#   variantformer_tpu_torch.api.visualization    expression_report, scatter_html
#   variantformer_tpu_torch.api.webapp           vcf2exp_app, vcf2risk_app, vcf2embed_app
#   variantformer_tpu_torch.api.live             LiveExpressionApp (model in the loop)
#   variantformer_tpu_torch.api.serving          export_forward, load_exported
