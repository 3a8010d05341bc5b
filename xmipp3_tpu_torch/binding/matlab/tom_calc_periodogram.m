function psd = tom_calc_periodogram(image, sz)
%TOM_CALC_PERIODOGRAM centered averaged periodogram of IMAGE at size SZ
%(default 512) for the CTF fitting functions. Runs on device through the
%bridge instead of the reference's MATLAB loop.
if nargin < 2, sz = 512; end
out = xmipp_matlab_bridge('periodogram', struct('image', image, 'sz', sz));
psd = out.psd;
end
