from xmipp3_tpu_torch.programs import main

raise SystemExit(main())
