function ctfFilter = xmipp_ctf_generate_filter(Xdim, Tm, params)
%XMIPP_CTF_GENERATE_FILTER centered CTF filter image of size Xdim for the
%CTF params struct (fields DeltafU, DeltafV, AzimuthalAngle, kV, Cs, Q0,
%K; missing fields default). Replaces xmipp_ctf_generate_filter.cpp.
args = params;
args.Xdim = Xdim;
args.Tm = Tm;
out = xmipp_matlab_bridge('ctf_generate_filter', args);
ctfFilter = out.ctfFilter;
end
