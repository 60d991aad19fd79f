from tamtr_torch.cli import main

main()
