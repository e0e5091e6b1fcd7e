"""CLI alias: `python -m recalgorithm_tpu_torch.cli.dcn_v2` trains DCNv2
(``cli.main`` with ``--model DCNv2`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="DCNv2")
