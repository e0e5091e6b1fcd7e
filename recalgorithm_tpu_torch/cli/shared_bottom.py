"""CLI alias: `python -m recalgorithm_tpu_torch.cli.shared_bottom` trains SharedBottom
(``cli.main`` with ``--model SharedBottom`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="SharedBottom")
